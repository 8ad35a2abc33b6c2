"""Plain PyTorch references that decide ``correct``. They import nothing of
the port: only torch, numpy and the benchmark's own inputs."""
