"""The benchmark's yardstick: finding cells, configurations, cases and
metrics by name (``spec``), the measured window (``window``), the trace and
its reduction to per-layer numbers (``trace``), the card's peaks and the
roofline arithmetic (``roofline``), and the comparison with the plain
reference that decides ``correct`` (``check``).  A cell's inputs, program
and numbers are its case's (``benchmark/cases``)."""
