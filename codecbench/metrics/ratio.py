"""Frame bytes over content bytes, summed over the window's compress
calls."""


def read(run):
    calls = [c for c in run.calls if c.kind == "compress" and c.ok]
    content = sum(c.content for c in calls)
    return sum(c.frame for c in calls) / content if content else None
