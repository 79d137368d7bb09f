"""Host ms a step inside the step entry's calls, by the benchmark's own
clock around each call (before it returns) over the traced run's timed
window: how long the host takes to issue a step's work."""


def read(ctx):
    return 1e3 * ctx.enqueue_s / ctx.steps_timed if ctx.steps_timed else None
