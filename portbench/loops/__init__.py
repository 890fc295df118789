"""The closed loops a traffic mix names (``"loop"`` in
``traffic/<mix>.json``), one file each: ``run(Run) -> dict`` drives the
window (:mod:`portbench.common`), ``numbers(records, cfg, mix, side,
device) -> dict`` gives what its check compares (:mod:`portbench.checks`).
A new loop is a new file."""
