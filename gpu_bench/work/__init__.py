"""The benchmark's frozen yardstick: the work of each measured layer from
its shapes (``arith``) and the card's peak rates (``peaks``).  Copies, not
imports: the program's own counts (``ops/kernels/work.py``) move when the
program moves, and these must not."""
