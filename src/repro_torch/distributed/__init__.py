"""Multi-device serving of the port: the serving mesh of one process
(:mod:`.mesh`), the partitioning of the kernel calls over it
(:mod:`.kernel_partition`) and the logical axes of the cache
(:mod:`.params`)."""
