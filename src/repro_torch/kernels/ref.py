"""Plain torch versions of the kernels — the oracles beside them.

Ring kernels (bitwise): `secure_matmul_combine` mirrors
repro/kernels/ref.py:87-98 (one party's Beaver combine). `ring_matmul` is
the wrapping integer product both kernels are built on. On the CPU it is
torch's own integer matmul; CUDA has none, so on the card it sums
K-chunked outer products elementwise. Both are exact ring arithmetic:
integer multiply and add wrap mod 2**bits.

Float kernels (allclose): `flash_attn`, `entropy_head` and
`mlp_softmax_attn` mirror repro/kernels/ref.py:8-43 in float32, with the
materialized (S x S) scores. They take the kernels' grouped layout —
q (BH, Sq, Dh) against k/v (BH / group, Skv, Dh) — and return q's dtype
(`entropy_head`: float32), as the kernels do.

Backward (allclose): `flash_attn_bwd`, `mlp_softmax_attn_bwd`,
`ssd_bwd` and `rg_lru_bwd` are the plain versions of the backward
kernels, in their own math — the probabilities recomputed from the row
log-sum-exp (flash_attn), the gradient through A = K^T W1 * scale and
U = W2 V (mlp_softmax_attn), the reverse recurrences of the scans step
by step (ssd, rg_lru) — held against autograd of the forwards here. k
and v's gradients sum over each kv head's group; ssd's b and c
gradients over the heads.

Scans (allclose): `ssd` and `rg_lru` mirror repro/kernels/ref.py:46-84,
step by step in float32. `ssd` also returns the final state, which the
port's kernel writes. `ssd_chunked` is the chunked SSD of
repro/models/ssd.py:48-92 (`ssd_scan`), op for op: the plain version of
the `ssd` kernel, which the CPU takes.
"""
from __future__ import annotations

import torch

# bound on the (..., M, chunk, N) intermediate of the card's version
_CHUNK_BYTES = 1 << 28


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Wrapping integer a @ b, broadcasting batch dims like torch.matmul."""
    if a.device.type == "cpu":
        return torch.matmul(a, b)
    return matmul_by_chunks(a, b)


def matmul_by_chunks(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as a sum over K-chunks of broadcast products — integer
    matmul from elementwise ops only (torch has no CUDA int matmul)."""
    k = a.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    per_k = batch.numel() * a.shape[-2] * b.shape[-1] * a.element_size()
    chunk = max(1, min(k, _CHUNK_BYTES // max(1, per_k)))
    out = None
    for k0 in range(0, k, chunk):
        part = (a[..., :, k0:k0 + chunk, None]
                * b[..., None, k0:k0 + chunk, :]).sum(-2, dtype=a.dtype)
        out = part if out is None else out + part
    return out


def secure_matmul_combine(eps, dlt, a_sh, b_sh, c_sh, party: int):
    """One party's Beaver combine: z_p = c_p + eps@b_p + a_p@dlt
    (+ party 0: eps@dlt), wrapping ring arithmetic."""
    z = c_sh + ring_matmul(eps, b_sh) + ring_matmul(a_sh, dlt)
    if party == 0:
        z = z + ring_matmul(eps, dlt)
    return z


def _up(x: torch.Tensor) -> torch.Tensor:
    """x in float32, or float64 if it is (so gradcheck can run the
    attention versions in double precision)."""
    return x if x.dtype == torch.float64 else x.float()


def _kv_for(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """k or v (BH / group, S, Dh) repeated to q's BH rows, in float32
    (float64 stays float64)."""
    return _up(t).repeat_interleave(q.shape[0] // t.shape[0], dim=0)


def flash_attn(q, k, v, *, causal: bool = True, window: int = 0,
               prefix_len: int = 0) -> torch.Tensor:
    """Exact softmax attention; `causal` needs Sq == Skv (key j <= query
    i), a causal `window` w > 0 also needs j > i - w (the "local" mask),
    and a causal `prefix_len` P > 0 also keeps j < P (the "prefix"
    mask)."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"causal attention needs Sq == Skv, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    s = _up(q) @ _kv_for(q, k).transpose(-1, -2) * q.shape[-1] ** -0.5
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        if window:
            mask = mask.triu(1 - window)
        mask[:, :prefix_len] = True
        s = s.masked_fill(~mask, float("-inf"))
    return (torch.softmax(s, dim=-1) @ _kv_for(q, v)).to(q.dtype)


def _group_sum(x: torch.Tensor, group: int) -> torch.Tensor:
    """(BH, ...) -> (BH / group, ...): the sum over each kv head's group."""
    return x.reshape((x.shape[0] // group, group) + tuple(x.shape[1:])).sum(1)


def flash_attn_bwd(q, k, v, o, do, *, causal: bool = True, window: int = 0,
                   prefix_len: int = 0):
    """(dq, dk, dv) of `flash_attn` given the output o and its gradient
    do: P = exp(S - lse), D = rowsum(do * o), dv = P^T do,
    dS = P * (do v^T - D), dq = dS k * scale, dk = dS^T q * scale; the
    masks are the forward's."""
    group, scale = q.shape[0] // k.shape[0], q.shape[-1] ** -0.5
    qf, dof = _up(q), _up(do)
    kf, vf = _kv_for(q, k), _kv_for(q, v)
    s = qf @ kf.transpose(-1, -2) * scale
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=s.device).tril()
        if window:
            mask = mask.triu(1 - window)
        mask[:, :prefix_len] = True
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    d = (dof * _up(o)).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - d)
    dq = ds @ kf * scale
    dk = _group_sum(ds.transpose(-1, -2) @ qf * scale, group)
    dv = _group_sum(p.transpose(-1, -2) @ dof, group)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def entropy_head(logits) -> torch.Tensor:
    """H = log Z - E_p[x] per row: (R, V) -> (R,) float32."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    e = torch.exp(x - m)
    z = e.sum(-1)
    return m[:, 0] + torch.log(z) - (x * e).sum(-1) / z


def mlp_softmax_attn(q, k, v, w1, b1, w2, b2) -> torch.Tensor:
    """MLP-emulated attention, materialized: probs = relu(S @ w1 + b1)
    @ w2 + b2 over the scores S, out = probs @ v."""
    s = _up(q) @ _kv_for(q, k).transpose(-1, -2) * q.shape[-1] ** -0.5
    probs = torch.relu(s @ _up(w1) + _up(b1)) @ _up(w2) + _up(b2)
    return (probs @ _kv_for(q, v)).to(q.dtype)


def mlp_softmax_attn_bwd(q, k, v, w1, b1, w2, b2, do):
    """(dq, dk, dv, dw1, db1, dw2, db2) of `mlp_softmax_attn` given do,
    through its reassociated form out = relu(q A + b1) U + u0:
    dU = H^T do, du0 = sum do, dZ = (do U^T) [Z > 0], dA = q^T dZ,
    dq = dZ A^T, then dk = scale w1 dA^T, dw1 = scale sum k dA,
    dw2 = sum dU v^T, dv = w2^T dU + b2 du0, db2 = sum v du0,
    db1 = sum dZ (sums over each kv head's group, then over the heads)."""
    group, scale = q.shape[0] // k.shape[0], q.shape[-1] ** -0.5
    qf, dof, kf, vf = _up(q), _up(do), _up(k), _up(v)
    w1, b1, w2, b2 = _up(w1), _up(b1), _up(w2), _up(b2)
    a = kf.transpose(-1, -2) @ w1 * scale                 # (BHk, Dh, hid)
    u = w2 @ vf                                           # (BHk, hid, Dh)
    ar, ur = (x.repeat_interleave(group, dim=0) for x in (a, u))
    z = qf @ ar + b1
    h = torch.relu(z)
    dz = (dof @ ur.transpose(-1, -2)) * (z > 0)
    dq = dz @ ar.transpose(-1, -2)
    da = _group_sum(qf.transpose(-1, -2) @ dz, group)
    du = _group_sum(h.transpose(-1, -2) @ dof, group)
    du0 = _group_sum(dof.sum(1), group)                  # (BHk, Dh)
    dk = w1 @ da.transpose(-1, -2) * scale
    dw1 = kf.transpose(0, 1).reshape(kf.shape[1], -1) \
        @ da.reshape(-1, da.shape[-1]) * scale
    dw2 = du.transpose(0, 1).reshape(du.shape[1], -1) \
        @ vf.transpose(-1, -2).reshape(-1, vf.shape[1])
    dv = w2.t() @ du + b2[:, None] * du0[:, None, :]
    db2 = vf.transpose(0, 1).reshape(vf.shape[1], -1) @ du0.reshape(-1)
    db1 = dz.sum((0, 1))
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dw1, db1, dw2,
            db2)


def ssd(x, a, b, c, state0=None):
    """Sequential state-space scan. x: (B, T, H, P) (dt-scaled inputs),
    a: (B, T, H) log decays, b, c: (B, T, N). Returns y (B, T, H, P)
    float32 and the final state (B, H, P, N) float32."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    state = (torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
             if state0 is None else state0.float())
    xf, af, bf, cf = x.float(), a.float(), b.float(), c.float()
    ys = []
    for i in range(t):
        state = state * torch.exp(af[:, i])[..., None, None] \
            + torch.einsum("bn,bhp->bhpn", bf[:, i], xf[:, i])
        ys.append(torch.einsum("bn,bhpn->bhp", cf[:, i], state))
    return torch.stack(ys, dim=1), state


def ssd_bwd(x, a, b, c, dy, dstate=None, state0=None):
    """(dx, da, db, dc, dstate0) of `ssd` given dy (B, T, H, P) and the
    final state's gradient `dstate` (B, H, P, N) or None, step by step
    in float32: with h_t = e^{a_t} h_{t-1} + x_t b_t^T, y_t = h_t c_t and
    dh_t = dy_t c_t^T + e^{a_{t+1}} dh_{t+1} (dh_{T+1} term: dstate),
    dx_t = dh_t b_t, db_t = sum_heads dh_t^T x_t, dc_t = sum_heads
    h_t^T dy_t, da_t = <dh_t, e^{a_t} h_{t-1}>, and dstate0 = e^{a_1}
    dh_1 (None without state0). dx, db and dc come back in x's, b's and
    c's dtype, da and dstate0 in float32."""
    bs, t, h, p = x.shape
    n = b.shape[-1]
    xf, af, bf, cf, dyf = x.float(), a.float(), b.float(), c.float(), \
        dy.float()
    hs = [torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
          if state0 is None else state0.float()]
    for i in range(t):
        hs.append(hs[-1] * torch.exp(af[:, i])[..., None, None]
                  + torch.einsum("bn,bhp->bhpn", bf[:, i], xf[:, i]))
    g = (torch.zeros_like(hs[0]) if dstate is None else dstate.float())
    dx, da, db, dc = (torch.empty_like(xf), torch.empty_like(af),
                      torch.empty_like(bf), torch.empty_like(cf))
    for i in reversed(range(t)):
        dh = g + torch.einsum("bhp,bn->bhpn", dyf[:, i], cf[:, i])
        dx[:, i] = torch.einsum("bhpn,bn->bhp", dh, bf[:, i])
        db[:, i] = torch.einsum("bhpn,bhp->bn", dh, xf[:, i])
        dc[:, i] = torch.einsum("bhpn,bhp->bn", hs[i + 1], dyf[:, i])
        decay = torch.exp(af[:, i])[..., None, None]
        da[:, i] = (dh * decay * hs[i]).sum((-1, -2))
        g = dh * decay
    return (dx.to(x.dtype), da, db.to(b.dtype), dc.to(c.dtype),
            None if state0 is None else g)


def segsum(a):
    """a: (..., Q) log decays -> (..., Q, Q) lower-triangular pairwise sums
    L[i, j] = sum_{j+1..i} a, -inf above the diagonal."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    seg = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return seg.masked_fill(~tri, float("-inf"))


def ssd_chunked(x, a, b, c, chunk: int = 128, state0=None):
    """Chunked SSD, as the JAX package's models/ssd.py:ssd_scan computes
    it: per chunk the intra-chunk term ((C B^T) * L) X, the state read
    C S^T exp(cum) and the state update. x: (B, T, H, P), a: (B, T, H),
    b, c: (B, T, N), T a multiple of min(chunk, T). Returns y in x's dtype
    and the final state (B, H, P, N) float32."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    chunk = min(chunk, t)
    assert t % chunk == 0
    nc = t // chunk
    xc = x.reshape(bsz, nc, chunk, h, p)
    ac = a.reshape(bsz, nc, chunk, h)
    bc = b.reshape(bsz, nc, chunk, n)
    cc = c.reshape(bsz, nc, chunk, n)
    state = (state0 if state0 is not None else
             torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device))
    ys = []
    for i in range(nc):
        x_, b_, c_ = xc[:, i].float(), bc[:, i].float(), cc[:, i].float()
        a_ = ac[:, i].float()
        cum = torch.cumsum(a_, dim=1)                     # (B,Q,H)
        L = torch.exp(segsum(a_.movedim(-1, 1)))          # (B,H,Q,Q)
        scores = torch.einsum("bqn,bsn->bqs", c_, b_)
        m = scores[:, None] * L
        y_diag = torch.einsum("bhqs,bshp->bqhp", m, x_)
        decay_in = torch.exp(cum)
        y_off = torch.einsum("bqn,bhpn->bqhp", c_, state) * decay_in[..., None]
        chunk_sum = cum[:, -1]                            # (B,H)
        decay_out = torch.exp(chunk_sum[:, None] - cum)   # (B,Q,H)
        new_contrib = torch.einsum("bqn,bqh,bqhp->bhpn", b_, decay_out, x_)
        state = state * torch.exp(chunk_sum)[..., None, None] + new_contrib
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.stack(ys, dim=1).reshape(bsz, t, h, p), state


def rg_lru(a, bterm, h0=None):
    """h_t = a_t * h_{t-1} + b_t. a, b: (B, T, D). Returns the h trace
    (B, T, D) float32."""
    bsz, t, d = a.shape
    h = (torch.zeros((bsz, d), dtype=torch.float32, device=a.device)
         if h0 is None else h0.float())
    af, bf = a.float(), bterm.float()
    hs = []
    for i in range(t):
        h = af[:, i] * h + bf[:, i]
        hs.append(h)
    return torch.stack(hs, dim=1)


def rg_lru_bwd(a, h, dh):
    """(da, db) of `rg_lru` from h_0 = 0, given a, the forward's trace h
    and its gradient dh (B, T, D), in float32: from g_{T+1} = 0,
    g_t = dh_t + a_{t+1} g_{t+1}, db_t = g_t, da_t = g_t h_{t-1}
    (h_0 = 0)."""
    af, hf, dhf = a.float(), h.float(), dh.float()
    t = a.shape[1]
    da, db = torch.empty_like(af), torch.empty_like(af)
    g = torch.zeros_like(af[:, 0])
    for i in reversed(range(t)):
        g = dhf[:, i] + af[:, i + 1] * g if i + 1 < t else dhf[:, i]
        db[:, i] = g
        da[:, i] = g * hf[:, i - 1] if i else torch.zeros_like(g)
    return da, db
