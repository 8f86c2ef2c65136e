"""Bytes the mesh exchanged per step (``DataMesh.collectives``: elements times element size of each
collective in the traced slice)."""


def read(r):
    return r.counters.get("exchanged_bytes_per_step")
