# Copied from blance_tpu/testing/__init__.py.
"""blance_tpu_torch.testing subpackage.

- :mod:`.vis` — plan/transition visualization helpers.
- :mod:`.sched` — deterministic asyncio schedule exploration (the
  controlled loop, seeded walks, bounded-exhaustive enumeration, and
  replayable schedule traces) used by the race-detection tier
  (``blance_tpu_torch.analysis.schedule``) and the regression tests.
"""
