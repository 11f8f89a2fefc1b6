"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a in
`csrc/`, built with nvcc and bound with ctypes by `build.py`).

  ring_matmul.py    batched wrapping int32/int64 GEMM — the integer
                    products the TPU build left to XLA
  secure_matmul.py  both parties' Beaver combine in one launch, on the
                    same u8 limb core — the port of the Pallas
                    secure_matmul kernel
  flash_attn.py     exact online-softmax attention (the target encoder,
                    the hybrid family's attention layers)
  entropy_head.py   one-pass row softmax entropy (target scoring,
                    the clear proxy's exact-entropy variants)
  mlp_softmax_attn.py  MLP-emulated attention without the S x S probs
                    (the clear proxy's "sm" variant)
  ssd.py            the Mamba-2 chunked state-space scan, with its final
                    state (the ssm family's prefill)
  rg_lru.py         the RG-LRU linear recurrence (the hybrid family's
                    recurrent layers in prefill)
  ref.py            plain torch versions (the oracles)
  ops.py            dispatch + launch counters
"""
