"""The paper's contribution, as composable modules:

  approx.py     MLP emulators: operators, Gaussian stats, ex-vivo fits
  proxy.py      proxy spec, generation (extract, stats, prune, build,
                in-vivo finetune), random weights, secret sharing
  tree.py       parameter trees: carrying weights across devices and
                from the JAX package, pytree leaf order, Adam
  target.py     the classifier target: forward, Oracle entropy,
                accuracy, finetune
  selection.py  the 3-stage workflow: selection_plan / run_selection,
                phase checkpoints, appraisal
  iosched.py    parallel MPC execution: latency-op coalescing + comm/
                compute overlap makespan (paper §4.4)
  executor.py   the wave-pipelined sieve executor (Stage 2), and Fig
                7's four schedule variants on one pool (run_variants)
  schedule_search.py  offline grid search over phase schedules, priced
                by the executed op stream (paper §4.2)
"""
