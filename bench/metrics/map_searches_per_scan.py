"""Map searches the program counted over the window
(``core/plan.py`` ``MAPSEARCH_CALLS``), a sweep."""
UNIT = "searches/scan"
SOURCE = "program_counter"
LAYER = "plan build (models/minkunet.py build_plans, core/plan.py)"
MOVES = "scans_per_s"


def read(ctx):
    if not ctx.scans:
        return None
    return ctx.run.counters["map_searches"] / ctx.scans
