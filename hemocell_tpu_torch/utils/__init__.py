"""Helpers around the solver: domain masks for flag matrices (``geometry``),
domain-wide fluid and particle statistics (``fluidinfo``), per-cell
statistics (``cellinfo``), the optical-tweezers force (``stretch``), and the
run's log, timers and metrics file (``logfile``, ``profiler``,
``metrics``)."""
