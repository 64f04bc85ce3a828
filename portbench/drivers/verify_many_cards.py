"""The closed-loop `verify_many` driver (drivers/verify_many.py) for a mesh
over the host's cards.  On a card it passes no `device` to
`batch.verify_many`, so a mesh of D shards lands on cuda:0 .. cuda:D-1: a
named device would put every shard on that one card, a virtual mesh.  On
the CPU it passes the CPU, which makes the mesh a virtual one there (the
tests' runs)."""

from portbench.drivers import verify_many


class Driver(verify_many.Driver):
    def __init__(self, workload: dict, traffic, device: str):
        super().__init__(workload, traffic, device)
        if device.startswith("cuda"):
            del self.kwargs["device"]
