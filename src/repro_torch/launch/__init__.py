"""Launchers: the serving and training entry points, the meshes
(`mesh`), the step builders they share (`steps`) and the dry-run
(`dryrun`)."""
