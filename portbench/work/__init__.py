"""The work a kernel's roofline share is held to, counted from the
benchmark's own reference and never from the program: a frozen table of
each scene node's operations (``work/nodes/<op>.json``), a frozen table of
the shader's operations around the distance evaluations
(``work/phases.json``), and the march steps of the reference's own marches
on the cell's cameras.  ``python -m portbench.work.count`` prints what the
reference's code counts to; ``portbench/tests`` hold the tables to it."""
