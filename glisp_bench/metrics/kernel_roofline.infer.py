"""The GNN kernels' share of their roofline over the traced stretch of a
timed pass, in %: the kernel calls' least card time (the frozen op
counts at the card's peaks) over the device time of the GNN kernels."""


def read(record: dict):
    if record.get("kind") != "infer":
        return None
    prof, bound = record.get("profile"), record.get("kernel_bound_s")
    if not prof or not prof.get("kernel_s") or not bound:
        return None
    return 100.0 * bound / prof["kernel_s"]
