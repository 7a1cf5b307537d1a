"""From the process's start to the window's start: imports, the kernel
library's load (and build, on a first run), operators, hierarchy, probe
and warm-up slab (host clock)."""


def read(summary):
    return summary["setup"]["setup_s"]
