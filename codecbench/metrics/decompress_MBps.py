"""Content bytes of all decompress calls in the window (10^6 bytes a MB),
over the sum of their walls: each from the call, with the frame in host
memory, to the content's bytes in host memory."""


def read(run):
    calls = [c for c in run.calls if c.kind == "decompress"]
    wall = sum(c.wall_s for c in calls)
    if not calls or wall <= 0:
        return None
    return sum(c.content for c in calls if c.ok) / 1e6 / wall
