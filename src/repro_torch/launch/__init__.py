"""Meshes of the port: the reliability mesh of data-parallel shards."""
