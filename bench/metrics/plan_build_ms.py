"""Mean wall ms of a request's plan build: the span around
``repro_torch.models.minkunet.build_plans`` as the serving engine looks it
up (map searches, fingerprints, tile streams)."""
UNIT = "ms"
SOURCE = "program_span"
LAYER = "plan build (models/minkunet.py build_plans, core/plan.py)"
MOVES = "scans_per_s"


def read(ctx):
    spans = [t1 - t0 for n, t0, t1 in ctx.run.spans if n == "plan_build"]
    return 1e3 * sum(spans) / len(spans) if spans else None
