"""Data-parallel training over torch.distributed: the process group and
host agreement (``multihost``), the data axis and its counted all-reduces
(``mesh``), and the data-parallel steps (``train``)."""
