"""Mean seconds per slide before the program's stage timer starts: model
build and weight load (the call's wall minus ``timings["total"]``)."""


def read(ctx):
    vals = [s["wall"] - s["timings"]["total"] for s in ctx.slides
            if s.get("timings")]
    return sum(vals) / len(vals) if vals else None
