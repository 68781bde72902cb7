"""Latent pixels decoded over the latent pixels asked for, less 1, in
percent: each response's bucket (``ServeResponse.padded_hw``) against
its latent, over every request due in the window.  An exact count."""


def read(ctx):
    c = ctx["counters"]
    if ctx["kind"] != "serve" or not c.get("real_latent_px"):
        return None
    return 100.0 * (c["padded_latent_px"] / c["real_latent_px"] - 1.0)
