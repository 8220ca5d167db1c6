"""host-sync fixture: the functions a ``ServeFns(...)`` hands the engine,
``prefill_rows`` among them, picked by a conditional expression, in
place or first bound to a local name.  Two findings: the synced rows
functions."""


class ServeFns:
    def __init__(self, **fns):
        self.fns = fns


def build(synced: bool):
    def _rows(module, cache, slots, tokens):
        if not len(slots):                  # len() of a tensor: metadata
            return tokens[:0]
        return tokens.index_select(0, slots)

    def _rows_synced(module, cache, slots, tokens):
        return tokens[:slots.max().item()]  # line 19: a host sync

    def _decode(module, cache, tokens):
        return tokens + 1

    return ServeFns(decode=_decode,
                    prefill_rows=_rows_synced if synced else _rows)


def build_bound(synced: bool):
    def _rows_bound(module, cache, slots, tokens):
        return tokens[:int(slots.sum())]    # line 30: a host sync

    rows = _rows_bound if synced else None
    return ServeFns(prefill_rows=rows)
