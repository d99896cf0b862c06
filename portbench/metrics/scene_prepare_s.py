"""Host seconds of the cell's first call in set-up: the scene's compile
(``ops/scene_program.py``), the build or the load of its native library
(``ops/_build.py``) and the first launch; the build counters are printed on
an earlier line."""


def read(run):
    return run.prepare_s
