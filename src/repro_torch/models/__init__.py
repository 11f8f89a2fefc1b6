"""Model building blocks — the dense subset of repro/models/ the target
classifier needs:

  common.py       init, norms, RoPE, activations, masks, cross-entropy
  attention.py    plain full / chunked GQA attention, and the flash_attn
                  kernel front the card uses
  ffn.py          dense FFN (MoE not ported)
  transformer.py  params and the decoder block (dense family, no cache)
"""
