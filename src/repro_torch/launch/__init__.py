"""Meshes of the port (the reliability mesh, the pod meshes, the host mesh
over a process group), the dry run's ECC structs and its analytic model."""
