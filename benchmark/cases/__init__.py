"""The cases: what runs a cell's traffic on its configuration.

A workload file names its case (``"case": "<name>"``), and the harness
loads ``cases/<name>.py`` by that name.  It holds a class
``Case(config, workload)`` with:

* ``nodes``: the lattice nodes an iteration updates (for ``mlups``);
* ``inputs(seed, device)``: the inputs, made from the seed;
* ``program(inputs, device)``: ``(run, state)``, the program's runner
  (``run(state, n)`` advances ``n`` iterations) and its first state;
* ``initial(inputs)`` and ``snapshot(state)``: what the reference takes
  as the start of a span, from the inputs and from the program's state;
* ``reference(dtype, tf32, device)``: the plain reference, whose
  ``follow(start, steps)`` gives the end of a span;
* ``judge(first, last, ref_first, ref_last)``: the numbers compared, from
  the program's ends of the two judged spans (the first chunk from the
  inputs, the window's last chunk) and the reference's.
"""
