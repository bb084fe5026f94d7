"""The data layer: vocabulary, caption files, image IO and prefetch.

Port of ``dalle_pytorch_tpu/data/``: NHWC numpy batches on the host,
copied to the device by the prefetch thread (``prefetch.py``).
"""
