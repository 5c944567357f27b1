"""Rows due for a re-mine over the rows the re-mine computed (all S of
each replay), over the window, %."""

from portbench.program import counted


def read(run):
    computed = counted(run, "remine.rows_computed")
    if not computed:
        return None
    return 100.0 * counted(run, "remine.rows_due") / computed
