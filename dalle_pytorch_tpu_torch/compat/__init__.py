"""Bridges to and from the JAX package's parameter trees, and the
reference's ``.pth`` state dicts (``torch_import``, ``torch_export``)."""
