"""Training metrics, the profiler hook and the debug guards
(``dalle_pytorch_tpu/utils/``)."""
