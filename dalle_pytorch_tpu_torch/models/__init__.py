"""DALLE and the VAE decoder, as torch modules."""
