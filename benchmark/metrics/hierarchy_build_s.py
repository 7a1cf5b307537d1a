"""build_stmg's wall on the host clock, synchronized before and after
(operators of every level, Vanka factors, the estimates or their cache)."""


def read(summary):
    return summary["setup"]["hierarchy_build_s"]
