"""Device ms a request of every operation other than K1
(``permute_rounds``) that starts inside a request's span: the runner's pack
and unpack, fills and copies; not the harness's copies of the answers the
check keeps, which it makes between requests."""


def read(rec):
    tr = rec.trace
    if tr is None or not rec.done:
        return None
    spans = [(s.t0, s.t1) for s in rec.done]
    return tr.seconds(lambda name: "permute_rounds" not in name, spans) \
        / len(rec.done) * 1e3
