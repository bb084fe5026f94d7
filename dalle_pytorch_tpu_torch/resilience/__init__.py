"""Resilience: fault injection, the training supervisor and bring-up.

Port of ``dalle_pytorch_tpu/resilience/``: ``faults`` (the training
hooks and the backend-claim hook under the ``DALLE_FAULTS`` plan),
``supervisor`` (preemption checkpoints, auto-resume, NaN and loss-spike
rollback with the learning-rate re-warm) and ``retry`` (the deadline,
backoff and jitter of the serving front end's device claim). ``faults``
also carries the replica set's hooks (crash, hang, flaky bring-up,
scale-out, upgrade and migration rows), those of process workers and
their transports, and the gateway's (cell down, tenant flood).
"""
