"""The whole training window's share of the card's float32 peak, in %:
the model FLOPs of every step's real rows (``yardstick.train_step_flops``)
over the window's seconds times the peak."""
from glisp_bench.harness.yardstick import train_step_flops


def read(record: dict):
    if record.get("kind") != "train" or not record.get("hw") or not record.get("batch_rows"):
        return None
    flops = sum(train_step_flops(record["model"], record["dims"], record["heads"],
                                 record["classes"], v, e, s)
                for v, e, s in record["batch_rows"])
    return 100.0 * flops / (record["window_s"] * record["hw"]["peak_flops_f32"])
