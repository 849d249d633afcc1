"""Import (the span `import_arrays` of engine.py: Engine.import_arrays,
through io/ingest.py and data/), host ms of one session as the program runs
it."""
from portbench.lib.spans import span_ms


def read(ctx):
    return span_ms(ctx, "import_arrays")
