"""Model FLOPs utilisation of serving (%): the forward FLOPs that
produced the output tokens reaching the client inside the window (each
token's position through the blocks, its attention over its context and
the head; a request's first token also its prompt's prefill), over the
window's seconds and the card's peak for the compute dtype."""
from portbench.yardstick import PEAK_OPS, serve_request_flops


def read(run):
    reqs = run.data.get("requests")
    if reqs is None or "window_tokens" not in run.data:
        return None
    cfg = run.config
    flops = sum(serve_request_flops(cfg["n_layer"], cfg["n_embd"],
                                    cfg["vocab_size"], len(r.prompt),
                                    r.win_lo, r.win_hi)
                for r in reqs if r.win_lo is not None)
    peak = PEAK_OPS[run.config["precision"]["compute"]]
    return 100.0 * flops / run.seconds / peak
