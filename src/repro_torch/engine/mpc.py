"""MPCEngine — share-level interpretation of the proxy forward.

Tensors are `Share`s over a `RingSpec` and a protocol backend
(`mpc/protocols/`): RING64 and RING32 share this one code path. The op
stream is fixed by `engine/forward.py` and keys derive deterministically
below, so a run is bitwise reproducible — across the executor's schedule
variants, against the JAX package, and between the card and the CPU.

Fixed-point scale flows through the forward as share metadata
(`Share.fb`, mpc/scale.py): products ride at 2f, pow2 rescales fold
free, and forced truncations fire only where the lattice demands — the
engine adds exactly one boundary rule of its own, `entropy_head`
returns CANONICAL-scale scores.

PRNG keys are threaded internally: the engine is seeded once per
forward (`with_key`) and derives one key per keyed op site by folding
an op counter.

Exact-op variant strategies (softmax / rsqrt / entropy when the MLP
emulator is ablated, plus the 2Quad and polynomial baseline softmaxes)
run the real CrypTen-style protocols from `mpc/nonlinear.py` — this is
what lets Table 3's baselines be *executed* over MPC, not only priced.
"""
from repro_torch.engine.forward import _mlp_at, attend_materialized
from repro_torch.mpc import (compare, fusion, nonlinear, prng, protocols,
                             ops as mops)
from repro_torch.mpc.ring import RING64, RingSpec
from repro_torch.mpc.sharing import Share


def _ax(axis: int) -> int:
    """Value axis -> share-array axis (leading party axis)."""
    return axis + 1 if axis >= 0 else axis


def mlp_apply_mpc(p_sh: dict, x: Share, key) -> Share:
    """Share-level emulator MLP: weights are model-owner-private shares.

    Cost: 2 secure matmuls (1 round each) + ReLU over `hidden` elements
    only — the dimension reduction the paper's MPC savings come from.
    """
    def _badd(h: Share, b: Share) -> Share:
        # build the broadcast from b (it carries b's exponent — h may
        # ride at 2f, and add() lifts the bias to match, exactly)
        bb = b.with_sh(b.sh[:, None, :].expand(tuple(h.sh.shape)))
        return mops.add(h, bb)

    k1, k2, k3 = prng.split(key, 3).unbind(-2)
    h = mops.matmul(x, p_sh["w1"], k1)
    h = _badd(h, p_sh["b1"])
    h = compare.relu(h, k2)
    out = mops.matmul(h, p_sh["w2"], k3)
    return _badd(out, p_sh["b2"])


class MPCEngine:
    kind = "mpc"

    def __init__(self, ring: RingSpec = RING64, variant=None, key=None,
                 protocol: str = "2pc"):
        self.ring = ring
        self.variant = variant
        self._key = key
        self._ctr = 0
        self.protocol = protocol
        self.backend = protocols.get(protocol)

    def with_key(self, key) -> "MPCEngine":
        """Fresh engine seeded for one forward (keys derive from here)."""
        return MPCEngine(self.ring, self.variant, key=key,
                         protocol=self.protocol)

    def fused(self, label: str):
        """Mark a group of independent ops: their openings ride one
        flight under an ambient `fusion.flight_scope` (no-op eagerly)."""
        return fusion.fused_group(label)

    def _k(self):
        if self._key is None:
            raise ValueError("MPCEngine needs a PRNG seed: call "
                             "engine.with_key(key) before the forward")
        k = prng.fold_in(self._key, self._ctr)
        self._ctr += 1
        return k

    # -- data entry ------------------------------------------------------
    def embed(self, pp, x_in, cfg):
        if not isinstance(x_in, Share):
            raise TypeError(
                "MPCEngine consumes shared embedded inputs (B, S, d): the "
                "data owner shares one-hot rows and the embedding matmul "
                "is folded into share generation (see mpc/sharing.share)")
        if x_in.proto != self.protocol:
            raise ValueError(
                f"engine protocol {self.protocol!r} but input shares are "
                f"{x_in.proto!r}")
        return x_in

    # -- linear algebra --------------------------------------------------
    # add/sub get a key: exponent alignment is usually an exact lift,
    # but a pow2-folded operand above the 2f cap must down-trunc EXACTLY
    def add(self, x, y):
        return mops.add(x, y, key=self._k())

    def sub(self, x, y):
        return mops.sub(x, y, key=self._k())

    def mul(self, x, y):
        return mops.mul(x, y, self._k())

    def mul_public(self, x, v):
        return mops.mul_public(x, v, key=self._k())

    def add_public(self, x, v):
        return mops.add_public(x, v)

    def matmul(self, x, y):
        # 2-D RING32 2PC products take the fused two-party secure_matmul
        # combine, as the JAX package routes its Pallas combine
        fused = self.ring.bits == 32 and self.protocol == "2pc"
        return mops.matmul(x, y, self._k(), fused_combine=fused)

    def mean(self, x, axis):
        return mops.mean(x, axis=axis, key=self._k())

    # -- shape ops (local on shares) -------------------------------------
    # Layout ops go through Share.derive: they are scale-preserving AND
    # remember their source, so a forced truncation on (say) a broadcast
    # inverse-std fires on the small pre-broadcast tensor.
    def shape(self, x):
        return x.shape

    def reshape(self, x, shape):
        return x.reshape(*shape)

    def broadcast(self, x, shape):
        # right-align the VALUE dims under the leading party axis
        shape = tuple(shape)
        pad = len(shape) - x.ndim
        val_shape = x.shape

        def fn(sh):
            sh = sh.reshape((sh.shape[0],) + (1,) * pad + val_shape)
            return sh.expand((sh.shape[0],) + shape)

        return x.derive(fn)

    def moveaxis(self, x, src, dst):
        return x.derive(lambda sh: sh.movedim(_ax(src), _ax(dst)))

    def swapaxes(self, x, a, b):
        return x.derive(lambda sh: sh.swapaxes(_ax(a), _ax(b)))

    def index(self, x, i):
        # no lineage: forcing a slice must not truncate the whole source
        return x.with_sh(x.sh[:, i])

    # -- nonlinearity strategies -----------------------------------------
    def mlp(self, p, x):
        return mlp_apply_mpc(p, x, self._k())

    def ln_inv(self, pp, li, var, variant):
        if "ln" in variant:
            return self.mlp(_mlp_at(pp["mlp_ln"], li), var)
        return nonlinear.rsqrt(mops.add_public(var, 1e-5), self._k())

    def attn_probs(self, pp, li, scores, variant):
        if "sm" in variant:
            return self.mlp(_mlp_at(pp["mlp_sm"], li), scores)
        if "quad_sm" in variant:
            return self._quad_softmax(scores)
        if "poly_sm" in variant:
            return self._poly_softmax(scores)
        return nonlinear.softmax(scores, self._k(), axis=-1)

    def attend(self, pp, li, qT, kT, v, variant):
        return attend_materialized(self, pp, li, qT, kT, v, variant)

    def entropy_head(self, pp, logits, variant):
        """Entropy scores, forced to CANONICAL scale: the forward's
        public boundary. Downstream consumers (QuickSelect ranking,
        appraisal means) see fb == frac_bits."""
        b = logits.shape[0]
        if "se" in variant:
            out = self.mlp(pp["mlp_se"], logits).reshape(b)
        else:
            out = nonlinear.entropy_from_logits(logits, self._k())
        out = mops.force(out, self._k())
        # Malicious backends (spdz2pc) verify every partial opening of
        # the forward with ONE batched MAC check at this boundary.
        # Semi-honest backends have no hook; nothing fires.
        check = getattr(self.backend, "mac_check_flight", None)
        if check is not None:
            check(self.ring)
        return out

    # -- Table-3 baseline softmaxes over shares --------------------------
    def _quad_softmax(self, scores):
        """MPCFormer 2Quad: (x+5)^2 / sum — square + NR reciprocal."""
        a = mops.add_public(scores, 5.0)
        e = mops.mul(a, a, self._k())
        s = mops.sum_(e, axis=-1, keepdims=True)
        # clamp mirroring the clear strategy's max(sum, 1e-6): keeps the
        # NR reciprocal away from a near-zero pole when every score in a
        # row sits near -5
        s = mops.add_public(s, 1e-6)
        r = nonlinear.reciprocal(s, self._k())
        rb = r.with_sh(r.sh.expand(e.sh.shape))
        return mops.mul(e, rb, self._k())

    def _poly_softmax(self, scores):
        """Bolt-style polynomial exp of clipped, max-shifted scores.

        clip(t, -8, 0) over shares: max(t,-8) = relu(t+8)-8, then
        min(u,0) = u - relu(u) — two comparisons per element, matching
        the baseline's real MPC cost profile. The comparisons are
        scale-invariant and their bits multiply at exponent 0, so the
        whole clip chain rides at the scores' carried exponent without
        a single truncation.
        """
        mx = compare.max_(scores, axis=-1, key=self._k())
        mb = mx.with_sh(mx.sh.expand(scores.sh.shape))
        # keyed subs: the max-shift may align carried exponents DOWN a
        # real truncation (keyless degrades to the local-shift path,
        # wrap-prone on RING32)
        t = mops.sub(scores, mb, key=self._k())
        lo = mops.add_public(compare.relu(mops.add_public(t, 8.0), self._k()),
                             -8.0)
        t = mops.sub(lo, compare.relu(lo, self._k()), key=self._k())
        # Horner: e = 1 + t(1 + t(1/2 + t(1/6 + t/24))) — one fused
        # flight: every message is a mask component, the public parts of
        # the chained openings reconstruct locally (fusion.py legality).
        # Each step's product emits at 2f and the next mul's headroom
        # plan forces exactly one trunc.
        with fusion.fused_group("horner"):
            acc = mops.add_public(mops.mul_public(t, 1.0 / 24.0,
                                                  key=self._k()), 1.0 / 6.0)
            acc = mops.add_public(mops.mul(t, acc, self._k()), 0.5)
            acc = mops.add_public(mops.mul(t, acc, self._k()), 1.0)
            e = mops.add_public(mops.mul(t, acc, self._k()), 1.0)
        e = compare.relu(e, self._k())
        s = mops.sum_(e, axis=-1, keepdims=True)
        r = nonlinear.reciprocal(s, self._k())
        rb = r.with_sh(r.sh.expand(e.sh.shape))
        return mops.mul(e, rb, self._k())
