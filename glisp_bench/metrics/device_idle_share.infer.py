"""The share of the traced stretch in which no operation ran on the card,
in %: 1 - busy / wall of the device trace."""


def read(record: dict):
    prof = record.get("profile")
    if record.get("kind") != "infer" or not prof or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
