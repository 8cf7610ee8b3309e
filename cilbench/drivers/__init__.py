"""One module a driver, found by the ``driver`` key of a cell's file:
``drivers/<driver>.py`` exposes ``run(ctx) -> dict``."""
