"""Sharded training over torch.distributed: the process group and host
agreement (``multihost``), the (data, pair) grid and its counted
all-reduces (``mesh``), the pair axis's halo exchanges and statistics
(``pair``), and the sharded steps (``train``)."""
