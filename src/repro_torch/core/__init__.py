"""The paper's contribution, as composable modules (ported so far):

  approx.py     MLP emulator initializer
  proxy.py      proxy spec, random/carried-over weights, secret sharing
  iosched.py    parallel MPC execution: latency-op coalescing + comm/
                compute overlap makespan (paper §4.4)
  executor.py   the wave-pipelined sieve executor (Stage 2)
"""
