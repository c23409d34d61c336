"""Traffic drivers, one module a driver, named by a cell's ``traffic``
field: each has ``run(ctx)``, which builds what the cell serves or trains,
warms it up, measures for ``ctx.seconds`` and judges what it produced."""
