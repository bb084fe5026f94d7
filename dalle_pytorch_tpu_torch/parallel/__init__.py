"""Training across devices: the process group, the mesh, collectives,
data, sequence and pipeline parallelism, and the training step."""
