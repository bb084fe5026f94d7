"""Resilience: fault injection, the training supervisor and bring-up.

Port of ``dalle_pytorch_tpu/resilience/``: ``faults`` (the training
hooks and the backend-claim hook under the ``DALLE_FAULTS`` plan),
``supervisor`` (preemption checkpoints, auto-resume, NaN and loss-spike
rollback with the learning-rate re-warm) and ``retry`` (the deadline,
backoff and jitter of the serving front end's device claim). The
serving faults of the fleet tier are not ported yet (ROADMAP.md queue
1).
"""
