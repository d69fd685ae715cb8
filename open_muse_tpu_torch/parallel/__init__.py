"""Multi-process training and serving: ``mesh`` (process groups, the device
mesh, the data-parallel reductions) and ``sharding`` (the parameter
partition rules).  The JAX package's ``kernel_mesh`` has no counterpart:
under ``torch.distributed`` each rank's kernels already see only its rows."""
