"""One driver a kind of traffic (a traffic file's ``kind``): each has ``run(cell, args, clock)`` and
``readings(cell, seed, device, variants, mesh)``."""
