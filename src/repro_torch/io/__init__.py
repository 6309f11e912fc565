"""POSIX file layer: pread-based stripe reads, layout math, NUMA helpers."""
from repro_torch.io.layout import StripePlan, Splinter, pieces_for_range, plan_session
from repro_torch.io.numa import detect_numa_domains, first_touch, parse_cpulist, pin_thread_to_cpus
from repro_torch.io.posix import DEFAULT_ALIGN, PosixFile, ShardedFile, aligned_floor, write_file

__all__ = [
    "PosixFile",
    "ShardedFile",
    "write_file",
    "DEFAULT_ALIGN",
    "aligned_floor",
    "StripePlan",
    "Splinter",
    "plan_session",
    "pieces_for_range",
    "detect_numa_domains",
    "first_touch",
    "parse_cpulist",
    "pin_thread_to_cpus",
]
