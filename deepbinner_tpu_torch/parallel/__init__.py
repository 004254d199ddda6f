"""Parallelism: the devices of a process, row splits, multi-process runs."""
