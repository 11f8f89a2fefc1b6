"""Additive 2PC with a trusted dealer — the CrypTen trust model.

Share layout: two uniform additive components on the leading axis,
`sh[0] + sh[1] = value` (mod 2**bits). Multiplication consumes Beaver
triples and (on RING32) truncation pairs from an offline dealer (crypto
provider): the dealer is a PRNG-keyed pure function, so triples are
reproducible; in deployment the dealer seed lives on the crypto-provider
host and shares are streamed ahead of the online phase.

Every byte the dealer ships is recorded into the ambient ledger's
OFFLINE channel (`tag="offline"`, 0 rounds): it never rides the online
wire, is excluded from `Ledger.nbytes`/makespan, and is reported
separately (`Ledger.offline_nbytes`).

Online wire model: an opening flight carries both parties' components
of every tensor at once — 1 round, `2 * elem_bytes * elems` bytes.
These flights are fusible under the deferred-reconstruction convention
(mpc/fusion.py).

Every integer product of this backend runs through a hand-written
kernel on the GPU (kernels/ops.py): torch has no CUDA matmul for int32
or int64. The dealer's `c = a @ b` and the generic combine go through
`ring_matmul`; the 2-D RING32 combine through the fused two-party
`secure_matmul`, gated exactly as the JAX package gates its Pallas
combine.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.mpc import comm, prng
from repro_torch.mpc.ring import RingSpec
from repro_torch.mpc.protocols.base import BackendDefaults, numel


def _share_raw(key: torch.Tensor, enc: torch.Tensor,
               ring: RingSpec) -> torch.Tensor:
    r = ring.rand(key, enc.shape)
    return torch.stack([r, enc - r])


def _record_offline(op: str, ring: RingSpec, n_elems: int) -> None:
    """Dealer-shipped correlated randomness: n_elems ring elements,
    additively shared to both parties."""
    comm.record(op, rounds=0, nbytes=2 * ring.elem_bytes * n_elems,
                numel=n_elems, tag="offline")


# ---------------------------------------------------------------------------
# the dealer (re-exported by mpc/beaver.py)
# ---------------------------------------------------------------------------

def mul_triple(key: torch.Tensor, shape, ring: RingSpec):
    """Elementwise triple: a*b = c (c at 2*frac scale — consumed pre-trunc)."""
    from repro_torch.mpc.sharing import Share
    ka, kb, k1, k2, k3 = prng.split(key, 5).unbind(-2)
    a = ring.rand(ka, shape)
    b = ring.rand(kb, shape)
    c = a * b   # ring product, wraps mod 2**bits
    _record_offline("offline.mul_triple", ring, 3 * numel(shape))
    return (Share(_share_raw(k1, a, ring), ring),
            Share(_share_raw(k2, b, ring), ring),
            Share(_share_raw(k3, c, ring), ring))


def matmul_triple(key: torch.Tensor, a_shape, b_shape, ring: RingSpec):
    """Matrix triple A@B = C for batched matmul shapes."""
    from repro_torch.mpc.sharing import Share
    ka, kb, k1, k2, k3 = prng.split(key, 5).unbind(-2)
    a = ring.rand(ka, a_shape)
    b = ring.rand(kb, b_shape)
    c = kops.ring_matmul(a, b)
    _record_offline("offline.matmul_triple", ring,
                    numel(a_shape) + numel(b_shape) + numel(c.shape))
    return (Share(_share_raw(k1, a, ring), ring),
            Share(_share_raw(k2, b, ring), ring),
            Share(_share_raw(k3, c, ring), ring))


def trunc_pair(key: torch.Tensor, shape, ring: RingSpec,
               shift: int | None = None):
    """Dealer-assisted truncation pair (r, r >> shift) — SecureML-style.

    `shift` defaults to one canonical scale (frac_bits); scale-carrying
    shares hand in their whole accumulated excess so ONE pair clears
    what eager mode paid as several.
    """
    from repro_torch.mpc.sharing import Share
    shift = ring.frac_bits if shift is None else shift
    kr, k1, k2 = prng.split(key, 3).unbind(-2)
    # r drawn from the "safe" range [0, 2**(bits-2)) to avoid sign wrap:
    # a LOGICAL shift of the unsigned view; torch's >> on signed ints is
    # arithmetic, so mask off the sign-extended bits
    r = (ring.rand(kr, shape) >> 2) & ((1 << (ring.bits - 2)) - 1)
    r_t = r >> shift             # arithmetic shift of non-negative r
    _record_offline("offline.trunc_pair", ring, 2 * numel(shape))
    return (Share(_share_raw(k1, r, ring), ring),
            Share(_share_raw(k2, r_t, ring), ring))


def triple_bytes(a_shape, b_shape, c_shape, ring: RingSpec) -> int:
    """Offline bytes the dealer ships for one triple (both parties)."""
    n = 0
    for s in (a_shape, b_shape, c_shape):
        n += numel(s)
    return 2 * ring.elem_bytes * n


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

class Additive2PC(BackendDefaults):
    name = "2pc"
    n_parties = 2
    n_wire_parties = 2

    # -- sharing --------------------------------------------------------
    def share_encoded(self, key: torch.Tensor, enc: torch.Tensor,
                      ring: RingSpec) -> torch.Tensor:
        return _share_raw(key, enc, ring)

    def from_public(self, enc: torch.Tensor) -> torch.Tensor:
        return torch.stack([enc, torch.zeros_like(enc)])

    def open_bytes(self, ring: RingSpec, n: int) -> int:
        return 2 * ring.elem_bytes * n

    # -- openings -------------------------------------------------------
    def _open_flight(self, op: str, tensors, ring: RingSpec, *, n: int,
                     flops: int = 0):
        """Open masked share tensors in ONE simultaneous message flight:
        1 round and 2 * elem_bytes * total-elements on the wire. Under
        comm.wave_scope the flight's bytes scale with the wave while
        latency-bound flights keep their rounds."""
        wire_elems = sum(numel(t.shape[1:]) for t in tensors)
        comm.record(op, rounds=1, nbytes=2 * ring.elem_bytes * wire_elems,
                    numel=n, flops=flops, tag="bw",
                    payload=[(p, 1 - p, t[p])
                             for t in tensors for p in (0, 1)])
        return tuple(t[0] + t[1] for t in tensors)

    # -- truncation -----------------------------------------------------
    def trunc(self, x, key: torch.Tensor | None, *,
              shift: int | None = None):
        """Divide shares by 2**shift (default: one canonical scale).

        RING64 (or keyless boundary trunc): local arithmetic shift of
        both components — correct up to ±1 LSB w.p. 1 - |v|/2**(bits-1)
        per element (CrypTen's choice). RING32: dealer-assisted pair
        (exact): open (x+r), shift publicly, subtract the dealer's share
        of r>>shift. Costs one opening round plus the pair's offline
        bytes — the SAME cost for any shift."""
        ring = x.ring
        shift = ring.frac_bits if shift is None else shift
        out_fb = x.fb - shift
        if ring.bits >= 64 or key is None:
            # torch's >> on signed ints is arithmetic, as the ring needs
            s0 = x.sh[0] >> shift
            s1 = -((-x.sh[1]) >> shift)
            return x.with_scale(torch.stack([s0, s1]), out_fb)
        # dealer-assisted exact truncation (RING32)
        r, r_t = trunc_pair(key, x.shape, ring, shift)
        masked = x.sh + r.sh
        m = masked[0] + masked[1]                # open
        comm.record("trunc_open", rounds=1,
                    nbytes=2 * ring.elem_bytes * numel(x.shape),
                    numel=numel(x.shape), tag="bw",
                    payload=[(0, 1, masked[0]), (1, 0, masked[1])])
        m_t = m >> shift
        pub = torch.stack([m_t, torch.zeros_like(m_t)])
        return x.with_scale(pub - r_t.sh, out_fb)

    # -- multiplication -------------------------------------------------
    def mul(self, x, y, key: torch.Tensor):
        """Beaver multiply. One opening round for (eps, delta); returns
        the raw product — `mpc/ops.py` owns the scale bookkeeping."""
        ring = x.ring
        shape = torch.broadcast_shapes(x.shape, y.shape)
        xb = x.sh.expand((2,) + tuple(shape))
        yb = y.sh.expand((2,) + tuple(shape))
        a, b, c = mul_triple(key, shape, ring)
        eps = xb - a.sh
        dlt = yb - b.sh
        n = numel(shape)
        eps_o, dlt_o = self._open_flight("beaver_mul", (eps, dlt), ring,
                                         n=n, flops=4 * n)
        z = c.sh + eps_o * b.sh + dlt_o * a.sh
        return x.with_sh(self.add_public_encoded(z, eps_o * dlt_o))

    def matmul(self, x, y, key: torch.Tensor, *,
               fused_combine: bool = False):
        """Beaver matrix-triple matmul. One opening round.

        Bytes on the wire: |eps| + |delta| per party = (numel(x)+numel(y))
        elems — the triple reuse is what makes 2PC matmul bandwidth-, not
        latency-, dominated.

        `fused_combine` routes the post-open combine of 2-D RING32
        matmuls through the two-party `secure_matmul` kernel: both
        parties' `z_p = c_p + eps@b_p + a_p@dlt (+ p0: eps@dlt)` in one
        launch. Every other combine runs as three `ring_matmul`s.
        Bitwise identical either way (exact wrapping ring arithmetic).
        """
        ring = x.ring
        a, b, c = matmul_triple(key, x.shape, y.shape, ring)
        eps = x.sh - a.sh
        dlt = y.sh - b.sh
        n = numel(x.shape) + numel(y.shape)
        m, k = x.shape[-2], x.shape[-1]
        n_out = y.shape[-1]
        batch = numel(x.shape[:-2])
        eps_o, dlt_o = self._open_flight("beaver_matmul", (eps, dlt), ring,
                                         n=n, flops=2 * batch * m * k * n_out)
        # party-local: z_p = c_p + eps@b_p + a_p@dlt ; party0 adds eps@dlt
        # Kernel eligibility: 2-D weights on the right. Batched left
        # operands flatten their batch dims into rows: row-wise ring
        # arithmetic is exact, so the flattened combine is bitwise
        # identical to the per-batch one.
        if fused_combine and ring.bits == 32 \
                and y.sh.ndim == 3 and x.sh.ndim >= 3:
            eps2 = eps_o.reshape(-1, k)
            z = kops.secure_matmul(eps2, dlt_o,
                                   a.sh.reshape(2, -1, k), b.sh,
                                   c.sh.reshape(2, -1, n_out))
            return x.with_sh(z.reshape(c.sh.shape))
        eb = kops.ring_matmul(eps_o.expand((2,) + tuple(eps_o.shape)), b.sh)
        ad = kops.ring_matmul(a.sh, dlt_o.expand((2,) + tuple(dlt_o.shape)))
        z = c.sh + eb + ad
        ed = kops.ring_matmul(eps_o, dlt_o)
        return x.with_sh(self.add_public_encoded(z, ed))
