"""The command-line entry points (``train_vae``, ``train_dalle``,
``gen_dalle``, ``train_clip``, ``mix_vae``) and what they share
(``common``)."""
