"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch path (the twins that the port runs on CPU tensors), with every
kernel route taken out, so that it runs the same plain code on any
device.  It imports neither JAX, nor the JAX package, nor anything of the
port, and takes nothing the program made: it starts from the frames and
the glibc bootstrap and works every state out again.  Run it in float32
with TF32 off (``ellc_bench/drivers`` do)."""
