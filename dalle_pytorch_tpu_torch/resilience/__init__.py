"""Training resilience: fault injection and the supervisor.

Port of the training half of ``dalle_pytorch_tpu/resilience/``:
``faults`` (the training hooks under the ``DALLE_FAULTS`` plan) and
``supervisor`` (preemption checkpoints, auto-resume, NaN and loss-spike
rollback with the learning-rate re-warm). ``retry.py`` (multi-host
bring-up) and the serving faults are not ported yet (ROADMAP.md queue 1).
"""
