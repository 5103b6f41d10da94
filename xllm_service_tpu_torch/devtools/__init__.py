"""Developer tooling: concurrency-invariant linting + instrumented locks
+ RCU publication discipline + state ownership + paired-effect
lifecycles.

One contract, repeated: a declared registry in the source, a static
xlint pass that cross-checks it bidirectionally, and an opt-in runtime
verifier that checks the dynamic paths static analysis cannot see:

- :mod:`.xlint` — an AST static-analysis pass enforcing the orchestration
  plane's concurrency and fault-plane invariants (lock discipline, lock
  ordering — threaded and ``async with`` alike, no blocking I/O under
  locks or inside coroutines, fault-point and metric registry hygiene,
  broad-except hygiene, and the RCU publication rules). Run with
  ``python -m xllm_service_tpu_torch.devtools.xlint xllm_service_tpu_torch`` (or the
  ``xlint`` console script; ``--support tests benchmarks`` for the
  relaxed support-code profile).
- :mod:`.locks` — a ``make_lock()`` factory the orchestration modules use
  instead of bare ``threading.Lock()``. Zero-overhead passthrough normally;
  under ``XLLM_LOCK_DEBUG=1`` every lock is instrumented so the existing
  test suite doubles as a race/deadlock detector (per-thread acquisition
  stacks, lock-order inversion detection against the statically declared
  order, held-lock detection across fault-injection yield points).
- :mod:`.rcu` — the RCU publication registry (``RCU_FROZEN_TYPES``,
  ``RCU_PUBLICATIONS``; the static authority for xlint's rcu rules) plus
  the ``publish()``/``thaw()`` runtime: passthrough normally, deep-freeze
  under ``XLLM_RCU_DEBUG=1`` so the same suite doubles as a
  snapshot-race detector.
- :mod:`.ownership` — the shared-state ownership model closing the
  unregistered middle between locks and RCU: ``STATE_DISCIPLINES``
  declares a discipline per mutable attribute (the authority for
  xlint's state rules), and under ``XLLM_STATE_DEBUG=1`` an
  instrumented ``__setattr__`` cross-checks every write at runtime.
- :mod:`.lifecycle` — the paired-effect registry (``EFFECT_PAIRS``; the
  authority for xlint's pair-release / pair-once / pair-evict rules)
  plus the ``XLLM_LEAK_DEBUG=1`` balance verifier: per-pair counters
  with acquisition stacks catch slot leaks, double-releases and
  resurrected metric series the static rules cannot reach.

The declared lock order lives in the source as ``# lock-order: N``
annotations on each lock declaration; xlint verifies the static
acquisition graph against it and ``locks`` verifies the dynamic one. The
RCU registries play the same role for publication discipline: xlint
verifies mutation/swap/read sites statically, ``rcu`` verifies the
dynamic paths static analysis cannot see (aliasing, callbacks).
"""
