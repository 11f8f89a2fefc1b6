"""Model building blocks — the port of repro/models/ for the classifier
targets (dense, cache-free) and the token server (ssm, hybrid):

  common.py       init, norms, RoPE, activations, masks, cross-entropy
  attention.py    plain full / chunked / decode GQA attention, and the
                  flash_attn kernel front the card uses
  ffn.py          dense FFN (MoE not ported)
  transformer.py  params, the decoder block, forward_logits, and the
                  ssm / hybrid serving path (init_cache, prefill,
                  decode_step)
  ssd.py          the Mamba-2 SSD mixer (prefill on the ssd kernel)
  rglru.py        the Griffin RG-LRU block (prefill on the rg_lru kernel)
"""
