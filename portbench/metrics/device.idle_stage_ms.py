"""Device idle time a profiled step while the host is inside the pinned
staging (the stage.* spans as the innermost program span), ms."""


def read(run):
    idle = (run.trace or {}).get("idle_in_program_s")
    if idle is None or not run.trace_steps:
        return None
    return sum(s for name, s in idle.items() if name.startswith("stage.")) / run.trace_steps * 1e3
