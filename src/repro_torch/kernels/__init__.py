"""Hand-written Hopper kernels of the port (CUDA C++ for sm_90a in
`csrc/`, built with nvcc and bound with ctypes by `build.py`).

  ring_matmul.py    batched wrapping int32/int64 GEMM — the integer
                    products the TPU build left to XLA
  secure_matmul.py  both parties' Beaver combine in one launch, on the
                    same u8 limb core — the port of the Pallas
                    secure_matmul kernel
  flash_attn.py     exact online-softmax attention (the target encoder,
                    the hybrid family's attention layers), with its
                    backward kernel (M_g's finetune)
  entropy_head.py   one-pass row softmax entropy (target scoring,
                    the clear proxy's exact-entropy variants)
  mlp_softmax_attn.py  MLP-emulated attention without the S x S probs
                    (the clear proxy's "sm" variant), with its backward
                    kernel (the proxy's in-vivo finetune)
  ssd.py            the Mamba-2 chunked state-space scan, with its final
                    state (the ssm family's prefill), with its backward
                    kernel (the zoo's training)
  rg_lru.py         the RG-LRU linear recurrence (the hybrid family's
                    recurrent layers in prefill), with its backward
                    kernel (the zoo's training)
  ref.py            plain torch versions (the oracles)
  ops.py            dispatch + launch counters

The kernel without a backward (`entropy_head`) refuses an input that
requires grad while grad mode is on (`refuse_grad`): its output would
silently carry no gradient.
"""


def refuse_grad(name: str, *tensors) -> None:
    """Raise if grad mode is on and any of `tensors` requires grad: kernel
    `name` has no backward, and its output would detach the graph."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} kernel has no backward: call it on inputs that do not "
            "require grad, or under torch.no_grad()")
