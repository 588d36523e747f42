"""One driver a kind of cell (the mix's ``kind``): ``run(cell)`` runs the
set-up, the window and the check, and returns an ``Outcome``."""
