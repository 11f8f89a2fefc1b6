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

Only the full MLP-emulator variant ("sm", "ln", "se": the MLPs plus
`compare.relu`) is ported. The exact-op strategies — CrypTen softmax,
NR rsqrt, secure entropy, the 2Quad and polynomial baseline softmaxes —
need `mpc/nonlinear.py`, which a later slice ports; they raise here.
"""
from repro_torch.engine.forward import _mlp_at, attend_materialized
from repro_torch.mpc import compare, fusion, prng, protocols, ops as mops
from repro_torch.mpc.ring import RING64, RingSpec
from repro_torch.mpc.sharing import Share


def _ax(axis: int) -> int:
    """Value axis -> share-array axis (leading party axis)."""
    return axis + 1 if axis >= 0 else axis


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} over MPC needs mpc/nonlinear.py, which is not ported yet: "
        "only the full MLP-emulator variant runs")


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
        _not_ported("the exact rsqrt")

    def attn_probs(self, pp, li, scores, variant):
        if "sm" in variant:
            return self.mlp(_mlp_at(pp["mlp_sm"], li), scores)
        if "quad_sm" in variant or "poly_sm" in variant:
            _not_ported("the baseline softmax")
        _not_ported("the exact softmax")

    def attend(self, pp, li, qT, kT, v, variant):
        return attend_materialized(self, pp, li, qT, kT, v, variant)

    def entropy_head(self, pp, logits, variant):
        """Entropy scores, forced to CANONICAL scale: the forward's
        public boundary. Downstream consumers (QuickSelect ranking,
        appraisal means) see fb == frac_bits."""
        b = logits.shape[0]
        if "se" not in variant:
            _not_ported("the exact entropy")
        out = self.mlp(pp["mlp_se"], logits).reshape(b)
        return mops.force(out, self._k())
