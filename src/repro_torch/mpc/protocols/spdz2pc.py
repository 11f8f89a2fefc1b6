"""SPDZ-style MAC'd additive 2PC — the malicious-security tier.

Share layout: FOUR rows on the leading axis — two value components and
two MAC components under the dealer's global key alpha:

    sh[0] + sh[1] = value          (mod 2**bits)
    sh[2] + sh[3] = alpha * value  (mod 2**bits)

Every linear op in `mpc/ops` is MAC-transparent (the MAC relation is
linear in the value); the two affine exceptions (`reconstruct`,
`add_public_encoded`) dispatch here, and the scheme's own ops below keep
the invariant through Beaver multiplication and dealer truncation.

Trust model (SPDZ with a trusted dealer for preprocessing): the dealer
ships MAC'd correlated randomness on the offline channel — each tensor
costs 4 components (value + MAC, both parties), double the semi-honest
dealer's bytes. Online, the parties may deviate arbitrarily:
correctness is enforced by information-theoretic MACs.

Openings are PARTIAL — parties exchange only value components (the
`2 * elem_bytes` wire profile of semi-honest 2PC). Each partial open
enqueues a deferred check obligation for
`sigma = (sh[2] + sh[3]) - alpha * opened` into the ambient `mac_scope`
state; ONE batched check at the forward's public boundary
(`mac_check_flight`, invoked by `MPCEngine.entropy_head`) verifies them
all — constant-size on the wire, recorded as a 1-round bw flight, plus
the dealer's one-time MAC-key shipment on the offline channel. An
obligation is kept as a 0-d device flag `(sigma != 0).any()`, not as
sigma itself (at BERT-base width one batch opens several GB), and
`MacState.verify` synchronises once for all of them.

Triples are authenticated by SACRIFICE: each multiply consumes a second
dealer triple and burns it in a 1-round correlation check. As in the
JAX package, `_sacrifice` only PRICES that check — its flight and its
offline bytes — and computes nothing, so the ledgers stay equal record
for record.

Truncation: local shifting is not MAC-preserving, so BOTH rings pay the
dealer trunc pair + one opening round.

Every integer product — the MAC'd triple's `c = a @ b` and the combine's
`eps @ b`, `a @ dlt` and `eps @ dlt` — is a `kernels.ops.ring_matmul`
launch on the card; nothing routes to `secure_matmul`.

Tamper injection (tests only): `tamper_scope(fn)` installs a fire-once
hook applied to the next stacked share tensor entering a partial open —
the adversary's bit flip. The next MAC check aborts with
`MacCheckError`; the semi-honest backends accept the same tamper
silently.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Iterator

import torch

from repro_torch.kernels import ops as kops
from repro_torch.mpc import comm, prng
from repro_torch.mpc.ring import RING32, RING64, RingSpec
from repro_torch.mpc.protocols.base import BackendDefaults, numel

_MAC_SEED = 0xA1C


class MacCheckError(AssertionError):
    """A batched SPDZ MAC check failed: an opened value was tampered."""


_state = threading.local()
# (ring bits, device) -> (alpha, alpha0, alpha1)
_MAC_KEYS: dict = {}


def _ring_of(sh) -> RingSpec:
    """The RingSpec of a stacked share, from its dtype (the affine hooks
    receive raw tensors; only two rings exist)."""
    return RING64 if sh.dtype.itemsize == 8 else RING32


def mac_key(ring: RingSpec, device=None):
    """The dealer's global MAC key alpha and its additive split
    (alpha0 + alpha1 = alpha), as 0-d tensors on `device` (the meta
    device included). Deterministic per ring — the simulation stands in
    for the dealer's one-time key generation; its shipment is priced by
    `mac_check_flight` (offline.mac_key)."""
    device = torch.device("cpu" if device is None else device)
    got = _MAC_KEYS.get((ring.bits, device))
    if got is None:
        k = prng.key(_MAC_SEED + ring.bits, device=device)
        alpha = ring.rand(k, ())
        a0 = ring.rand(prng.fold_in(k, 1), ())
        got = _MAC_KEYS[ring.bits, device] = (alpha, a0, alpha - a0)
    return got


# ---------------------------------------------------------------------------
# deferred MAC-check state + the test-only tamper hook
# ---------------------------------------------------------------------------

def _readable(t: torch.Tensor) -> bool:
    """A tensor whose values exist here: not a meta tensor of the probe,
    not a lane-batched tensor under `torch.func.vmap` (the executor's
    coalesced waves)."""
    return not t.is_meta and not torch._C._functorch.is_batchedtensor(t)


class MacState:
    """Deferred MAC-check obligations of one verification scope.

    Each partial open appends a 0-d device flag, `(sigma != 0).any()`
    with sigma = gamma_sum - alpha * opened; honest executions keep
    every flag False. Obligations that cannot be read here — a tensor
    under vmap, a meta tensor — are counted in `n_traced` instead; the
    eager forward makes every obligation readable."""

    def __init__(self) -> None:
        self.flags: list[tuple[str, torch.Tensor]] = []
        self.n_opened = 0
        self.n_traced = 0

    def verify(self) -> None:
        """The batched check: one synchronisation, abort on the first
        (in order) obligation whose sigma is nonzero."""
        if not self.flags:
            return
        bad = torch.stack([f for _, f in self.flags]).tolist()
        for (op, _), b in zip(self.flags, bad):
            if b:
                raise MacCheckError(
                    f"spdz2pc MAC check failed on {op!r}: an opened value "
                    f"or its MAC was tampered with — aborting")
        self.flags.clear()


@contextlib.contextmanager
def mac_scope() -> Iterator[MacState]:
    """Collect MAC obligations for every partial open inside; verify via
    `MacState.verify()` (the engine boundary calls it through
    `mac_check_flight`). Thread-local."""
    prev = getattr(_state, "mac", None)
    st = MacState()
    _state.mac = st
    try:
        yield st
    finally:
        _state.mac = prev


def get_mac_state() -> MacState | None:
    return getattr(_state, "mac", None)


@contextlib.contextmanager
def tamper_scope(fn) -> Iterator[None]:
    """TEST-ONLY adversary: `fn(stacked) -> stacked` is applied ONCE to
    the next share tensor entering a partial open (rows 0/1 = value
    components, rows 2/3 = MAC components — flip a bit in either)."""
    prev = getattr(_state, "tamper", None)
    _state.tamper = {"fn": fn, "fired": False}
    try:
        yield
    finally:
        _state.tamper = prev


def _maybe_tamper(sh: torch.Tensor) -> torch.Tensor:
    t = getattr(_state, "tamper", None)
    if t is None or t["fired"]:
        return sh
    t["fired"] = True
    return t["fn"](sh)


def _note_open(op: str, opened: torch.Tensor, gamma: torch.Tensor,
               ring: RingSpec) -> None:
    st = get_mac_state()
    if st is None:
        return
    st.n_opened += 1
    if not (_readable(opened) and _readable(gamma)):
        st.n_traced += 1
        return
    alpha, _, _ = mac_key(ring, opened.device)
    st.flags.append((op, (gamma - alpha * opened != 0).any()))


# ---------------------------------------------------------------------------
# the MAC'd dealer
# ---------------------------------------------------------------------------

def _share_mac(key: torch.Tensor, enc: torch.Tensor,
               ring: RingSpec) -> torch.Tensor:
    """(4, *shape): additive split of enc stacked on an additive split
    of alpha * enc."""
    alpha, _, _ = mac_key(ring, enc.device)
    kx, km = prng.split(key, 2).unbind(-2)
    rx = ring.rand(kx, enc.shape)
    rm = ring.rand(km, enc.shape)
    gm = alpha * enc
    return torch.stack([rx, enc - rx, rm, gm - rm])


def _record_offline_mac(op: str, ring: RingSpec, n_elems: int) -> None:
    """Dealer-shipped MAC'd correlated randomness: each of n_elems ring
    elements costs 4 components (value + MAC, both parties)."""
    comm.record(op, rounds=0, nbytes=4 * ring.elem_bytes * n_elems,
                numel=n_elems, tag="offline")


def _mac_mul_triple(key: torch.Tensor, shape, ring: RingSpec):
    ka, kb, k1, k2, k3 = prng.split(key, 5).unbind(-2)
    a = ring.rand(ka, shape)
    b = ring.rand(kb, shape)
    c = a * b
    _record_offline_mac("offline.mul_triple", ring, 3 * numel(shape))
    return (_share_mac(k1, a, ring), _share_mac(k2, b, ring),
            _share_mac(k3, c, ring))


def _mac_matmul_triple(key: torch.Tensor, a_shape, b_shape, ring: RingSpec):
    ka, kb, k1, k2, k3 = prng.split(key, 5).unbind(-2)
    a = ring.rand(ka, a_shape)
    b = ring.rand(kb, b_shape)
    c = kops.ring_matmul(a, b)
    _record_offline_mac("offline.matmul_triple", ring,
                        numel(a_shape) + numel(b_shape) + numel(c.shape))
    return (_share_mac(k1, a, ring), _share_mac(k2, b, ring),
            _share_mac(k3, c, ring))


# ---------------------------------------------------------------------------
# the backend
# ---------------------------------------------------------------------------

class SPDZ2PC(BackendDefaults):
    name = "spdz2pc"
    # leading-axis size of Share.sh: 2 value + 2 MAC rows
    n_parties = 4
    # ... but the WIRE has exactly 2 physical parties: partial opens
    # exchange value rows only (BackendDefaults.open_msgs routes 0<->1)
    n_wire_parties = 2
    # dealer MAC'd trunc pairs are exact at any shift/exponent, so the
    # scale lattice may defer up to the ring-wide 3f headroom cap
    exact_trunc = True

    # -- sharing --------------------------------------------------------
    def share_encoded(self, key: torch.Tensor, enc: torch.Tensor,
                      ring: RingSpec) -> torch.Tensor:
        return _share_mac(key, enc, ring)

    def from_public(self, enc: torch.Tensor) -> torch.Tensor:
        _, a0, a1 = mac_key(_ring_of(enc), enc.device)
        z = torch.zeros_like(enc)
        return torch.stack([enc, z, a0 * enc, a1 * enc])

    def open_bytes(self, ring: RingSpec, n: int) -> int:
        # PARTIAL open: value components only — MACs stay secret
        return 2 * ring.elem_bytes * n

    # -- affine hooks (MAC rows are not value components) ---------------
    def reconstruct(self, sh: torch.Tensor) -> torch.Tensor:
        ring = _ring_of(sh)
        sh = _maybe_tamper(sh)
        v = sh[0] + sh[1]
        _note_open("open", v, sh[2] + sh[3], ring)
        return v

    def add_public_encoded(self, sh: torch.Tensor, enc) -> torch.Tensor:
        """Out of place (`.at[i].add` in the JAX package), so it stays a
        plain tensor op under vmap and on meta tensors. `enc` may be a
        Python int (a public scalar encodes on the host)."""
        _, a0, a1 = mac_key(_ring_of(sh), sh.device)
        return torch.stack([sh[0] + enc, sh[1], sh[2] + a0 * enc,
                            sh[3] + a1 * enc])

    # -- openings -------------------------------------------------------
    def _open_flight(self, op: str, tensors, ring: RingSpec, *, n: int,
                     flops: int = 0):
        """Partially open masked tensors in ONE flight (value components
        only) and enqueue each tensor's MAC obligation for the batched
        boundary check."""
        wire_elems = sum(numel(t.shape[1:]) for t in tensors)
        comm.record(op, rounds=1, nbytes=2 * ring.elem_bytes * wire_elems,
                    numel=n, flops=flops, tag="bw",
                    payload=[(p, 1 - p, t[p])
                             for t in tensors for p in (0, 1)])
        out = []
        for t in tensors:
            t = _maybe_tamper(t)
            v = t[0] + t[1]
            _note_open(op, v, t[2] + t[3], ring)
            out.append(v)
        return tuple(out)

    # -- truncation -----------------------------------------------------
    def trunc(self, x, key: torch.Tensor | None, *,
              shift: int | None = None):
        """Dealer-assisted MAC'd truncation — BOTH rings: open x + r
        (partially) and rebuild from the dealer's MAC'd (r, r >> shift)
        pair. One opening round + 2 MAC'd tensors of offline bytes per
        force, any shift. There is no MAC-preserving local shift, so a
        call with no key raises."""
        ring = x.ring
        if key is None:
            raise ValueError(
                "spdz2pc truncation requires a PRNG key: there is no "
                "MAC-preserving local-shift path (the engine threads a "
                "key through every force site)")
        shift = ring.frac_bits if shift is None else shift
        out_fb = x.fb - shift
        n = numel(x.shape)
        kr, k1, k2 = prng.split(key, 3).unbind(-2)
        # r from the "safe" range [0, 2**(bits-2)): a logical shift,
        # masked as additive2pc.trunc_pair does
        r = (ring.rand(kr, x.shape) >> 2) & ((1 << (ring.bits - 2)) - 1)
        r_t = r >> shift
        rsh = _share_mac(k1, r, ring)
        rtsh = _share_mac(k2, r_t, ring)
        _record_offline_mac("offline.trunc_pair", ring, 2 * n)
        (m,) = self._open_flight("trunc_open", (x.sh + rsh,), ring, n=n)
        m_t = m >> shift
        _, a0, a1 = mac_key(ring, m_t.device)
        out = torch.stack([m_t - rtsh[0], -rtsh[1],
                           a0 * m_t - rtsh[2], a1 * m_t - rtsh[3]])
        return x.with_scale(out, out_fb)

    # -- multiplication -------------------------------------------------
    def _sacrifice(self, op: str, ring: RingSpec, n_triple: int,
                   n_open: int, wire_elems: int) -> None:
        """Price burning a second dealer triple to authenticate the
        first: the sacrificed triple's MAC'd bytes on the offline channel
        and the 1-round correlation-check open. Like the JAX package's,
        it records and computes nothing else — the check itself is not
        run."""
        _record_offline_mac(f"offline.sacrifice_{op}", ring, n_triple)
        comm.record("sacrifice", rounds=1,
                    nbytes=2 * ring.elem_bytes * wire_elems,
                    numel=n_open, tag="bw")

    def mul(self, x, y, key: torch.Tensor):
        """Authenticated Beaver multiply: sacrifice flight + (eps, delta)
        partial open; MAC rows recombine with the split of alpha on the
        public eps*delta term. Raw product — `mpc/ops.py` owns scale."""
        ring = x.ring
        shape = tuple(torch.broadcast_shapes(x.shape, y.shape))
        xb = x.sh.expand((4,) + shape)
        yb = y.sh.expand((4,) + shape)
        n = numel(shape)
        a4, b4, c4 = _mac_mul_triple(key, shape, ring)
        self._sacrifice("triple", ring, 3 * n, n, 2 * n)
        eps, dlt = self._open_flight("beaver_mul", (xb - a4, yb - b4), ring,
                                     n=n, flops=4 * n)
        z = c4 + eps * b4 + dlt * a4
        return x.with_sh(self.add_public_encoded(z, eps * dlt))

    def matmul(self, x, y, key: torch.Tensor, *,
               fused_combine: bool = False):
        """Authenticated Beaver matmul (the input-proportional wire
        profile of semi-honest 2PC, plus the sacrifice flight and the
        doubled MAC'd triple bytes offline). `fused_combine` is the
        semi-honest 2-row kernel knob and is ignored."""
        ring = x.ring
        a4, b4, c4 = _mac_matmul_triple(key, x.shape, y.shape, ring)
        na, nb = numel(x.shape), numel(y.shape)
        nc = numel(c4.shape[1:])
        self._sacrifice("matmul_triple", ring, na + nb + nc, na + nb,
                        na + nb)
        m, k = x.shape[-2], x.shape[-1]
        n_out = y.shape[-1]
        batch = numel(x.shape[:-2])
        eps, dlt = self._open_flight("beaver_matmul",
                                     (x.sh - a4, y.sh - b4), ring,
                                     n=na + nb,
                                     flops=2 * batch * m * k * n_out)
        eb = kops.ring_matmul(eps.expand((4,) + tuple(eps.shape)), b4)
        ad = kops.ring_matmul(a4, dlt.expand((4,) + tuple(dlt.shape)))
        z = c4 + eb + ad
        ed = kops.ring_matmul(eps, dlt)
        return x.with_sh(self.add_public_encoded(z, ed))

    # -- the boundary check ---------------------------------------------
    def mac_check_flight(self, ring: RingSpec) -> None:
        """Batched MAC check at the forward's public boundary (invoked
        by `MPCEngine.entropy_head`): constant-size regardless of how
        many values were opened — 1 fusible bw round, plus the dealer's
        one-time MAC-key shipment (offline). When a `mac_scope` is
        ambient, the deferred obligations are verified here — a tampered
        execution aborts at its output."""
        comm.record("offline.mac_key", rounds=0,
                    nbytes=2 * ring.elem_bytes, numel=1, tag="offline")
        comm.record("mac_check", rounds=1, nbytes=4 * ring.elem_bytes,
                    numel=1, tag="bw")
        st = get_mac_state()
        if st is not None:
            st.verify()
