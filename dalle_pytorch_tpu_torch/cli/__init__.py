"""The command-line entry points (``train_vae``, ``train_dalle``,
``gen_dalle``, ``train_clip``, ``mix_vae``, ``import_torch``) and what
they share (``common``)."""
