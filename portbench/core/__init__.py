"""The harness: the manifest and its files (``manifest``), the inputs made
from the seed (``inputs``), the program under test (``program``), the
measured window (``window``), the profiler's reduction (``trace``), the
roofline's work (``roofline``), the comparison that decides ``correct``
(``check``) and one run of a cell (``cell``)."""
