"""Architecture configs of the port (ArchConfig + the paper's targets)."""
