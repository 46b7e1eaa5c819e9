"""The share of the padded serving rows that carried requests' vertices
over the window (``ServeStats`` rows over padded rows), in %."""


def read(record: dict):
    if record.get("kind") != "serve" or record.get("occupancy") is None:
        return None
    return 100.0 * record["occupancy"]
