"""One module a kind of cell: ``run(ctx)`` drives the system under test and
returns what the result line needs."""
