"""The paper's contribution, as composable modules (ported so far):

  approx.py     MLP emulator initializer
  proxy.py      proxy spec, random/carried-over weights, secret sharing
  tree.py       parameter trees: carrying weights across devices and
                from the JAX package, pytree leaf order
  target.py     the classifier target's forward: Oracle entropy, accuracy
  selection.py  the sieve's clear side: phase schedule and a clear phase
  iosched.py    parallel MPC execution: latency-op coalescing + comm/
                compute overlap makespan (paper §4.4)
  executor.py   the wave-pipelined sieve executor (Stage 2)
"""
