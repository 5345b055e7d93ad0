"""Benchmark tower — harness parity with the reference's benchmark/ tree.

Reference counterparts (SURVEY §2.8):
  corpus.py   ← benchUtils.js synthetic corpus + benchSilesia.js corpus
  sysinfo.py  ← sysInfo.js banner (plus the device list)
  runner.py   ← benchRunner.js + benchUtils.js measurement engine
  profiler.py ← profile.compression.js / profile.decompression.js
                (jax.profiler traces instead of V8 .cpuprofile)

The reference isolates samples in subprocesses with --expose-gc; here
measurement uses jit-cache warm-up + median-of-N instead (SURVEY §7 Phase 4).
"""
