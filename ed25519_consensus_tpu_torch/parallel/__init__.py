"""The sharded mesh: placement (mesh.py) and the sharded window sums
(sharded_msm.py)."""
