"""Model building blocks — the port of repro/models/ for the classifier
targets and the model zoo's forward and serving path:

  common.py       init, norms, RoPE, activations, masks, cross-entropy
  attention.py    plain full / chunked / decode GQA attention, and the
                  flash_attn kernel front the card uses
  ffn.py          dense FFN and the top-k MoE FFN
  transformer.py  params, the decoder block, forward_logits, and the
                  serving path of every family (init_cache, prefill,
                  decode_step; int8 KV caches for dense and vlm)
  ssd.py          the Mamba-2 SSD mixer (prefill on the ssd kernel)
  rglru.py        the Griffin RG-LRU block (prefill on the rg_lru kernel)
"""
