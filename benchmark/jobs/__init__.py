"""The entries the benchmark drives, one module a port entry point.

A configuration's ``entry`` names the module here. Each holds a ``Job``:

* ``Job(config, traffic, seed, device)`` builds the system under test
  from the configuration and the traffic mix, makes its inputs from the
  seed and warms up every shape the window will use (all of it set-up);
* ``unit`` ("reps", "steps"): what ``step()`` completes;
* ``step() -> int``: one call of the entry, the units it completed; the
  call returns only when its results are on the host;
* ``launch_shapes() -> {counter: shape}``: the shape of each kernel
  launch the window makes, by the port's ``LAUNCHES`` counter name;
* ``step_ops() -> float | None``: the operations of one unit;
* ``finish()``: frees the program's state;
* ``answers()``: every answer of the window (a non-finite one fails);
* ``check() -> {name: [value]}``: after ``finish``, the gaps to the
  plain reference of each answer compared; the widest of each name is
  held to the cell's limit of that name.
"""
