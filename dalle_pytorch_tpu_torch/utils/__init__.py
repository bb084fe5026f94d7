"""Training metrics and the profiler hook (``dalle_pytorch_tpu/utils/``)."""
