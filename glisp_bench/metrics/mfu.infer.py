"""The timed passes' share of the card's float32 peak, in %: the model
FLOPs of every layer slice's real rows and edges
(``yardstick.slice_flops``) over the passes' seconds times the peak."""
from glisp_bench.harness.yardstick import slice_flops


def read(record: dict):
    if record.get("kind") != "infer" or not record.get("hw") or not record.get("slice_rows"):
        return None
    dims = record["dims"]
    flops = sum(slice_flops(record["model"], din, dims[k + 1], record["heads"], rows, edges)
                for k, rows, edges, din in record["slice_rows"])
    return 100.0 * flops / (record["window_s"] * record["hw"]["peak_flops_f32"])
