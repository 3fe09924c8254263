"""The plain reference of the benchmark's check: frozen copies of the
port's plain versions (the branches its modules take on CPU tensors, which
the repository's tests hold against the JAX package), taken at the commit
that added the benchmark, with the CUDA dispatch removed so that they run
plain on any device. Module docstrings keep the port's text; where they
name a kernel, the code here is that kernel's plain version.

Nothing here imports the port, the JAX package or JAX; the check hands
these functions the program's inputs and compares their outputs."""
