"""Device milliseconds per train batch that end at the program's
``query`` marks (``Trainer.train_epoch(marks=...)``): the gap from the
mark before to each ``query`` mark, averaged over one superchunk."""


def read(ctx):
    marks = ctx.get("marks_ms") or {}
    return marks.get("query")
