"""Sharding rules (`specs`: spec tuples and DTensor placements for the
production meshes), the context of a sharded step and its collectives
(`parallel`, which the models import), and placing and running a model
by the plan (`execute`)."""
