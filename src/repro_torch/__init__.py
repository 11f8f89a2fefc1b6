"""SelectFormer reproduction on PyTorch and CUDA — the port of `repro`.

Module paths mirror `src/repro/` so every counterpart is easy to find;
the package imports torch, never jax, and nothing of `repro`. Entry
points run on the card (`device="cuda"`) unless the caller passes
`device="cpu"`. Ported so far:

  * the private sieve's serving path — `core/executor.WaveExecutor.
    score_phase` over `engine/forward.proxy_entropy` interpreted by
    `engine/mpc.MPCEngine` on any of the four protocol backends
    (`mpc/protocols/`: additive 2PC, replicated 3PC, ABY3's exact
    truncation and the MAC'd malicious SPDZ tier; RING32 and RING64),
    then `mpc/quickselect.top_k_indices` — with its integer
    products on the hand-written ring kernels of `kernels/`;
  * the clear scoring paths — the target classifier's forward
    (`core/target`: Oracle entropy and accuracy, attention on the
    `flash_attn` kernel, entropy on `entropy_head`) and the clear sieve
    phase (`core/selection.clear_phase` over `engine/clear.ClearEngine`,
    MLP_sm attention on `mlp_softmax_attn`);
  * token serving of the ssm (Mamba-2) and hybrid (RecurrentGemma)
    families — `launch/serve.Server` over `models/transformer`'s
    `prefill` and `decode_step` — with the SSD scan on the `ssd` kernel,
    the RG-LRU recurrence on `rg_lru` and the local attention on
    `flash_attn` in prefill;
  * the selection pipeline from `core/selection.run_selection` down, with
    its training on the card (the backward kernels of `flash_attn` and
    `mlp_softmax_attn`), the exact-op MPC baselines (`mpc/nonlinear`),
    the analytic cost mirror (`mpc/costs`, `core/schedule_search`) and
    the launcher `launch/select`;
  * the appraisal service — `serve/` (sessions over `selection_plan`,
    the round-robin wave interleaver, the offline dealer drawing its
    material on the card, the cross-session phase cache, the throughput
    report) and `launch/serve --appraise` — with `checkpoint/`, the
    manifest-verified checkpoints the cache persists through;
  * the real wire and its recovery — `net/` (transports, seeded fault
    injection, `PartyRuntime` replaying a phase's captured flights as
    threads or spawned processes) and `runtime/ft` — under the
    executor's `wire=` and `launch/select --wire`. These two packages
    import neither torch nor anything of the port that does;
  * the model zoo's training — `launch/train` over `models/transformer.
    train_loss` (with remat), `optim/` and `data/pipeline` — with the
    backward kernels of `flash_attn` (every head dim and mask), `ssd`
    and `rg_lru` on the card.
"""
