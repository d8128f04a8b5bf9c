"""Host milliseconds a tree of DART's own steps: the self time of the
program's ``qr.dart.*`` spans (the dropout draws and the delta's launches,
the restore, the compaction, the full rescore: their length less what
program spans inside them cover, such as the read-backs), over the traced
job's trees.  One sweep over the spans in start order: a traced job holds
tens of thousands of them."""

from benchmark.metrics import _spans


def read(ctx):
    spans = _spans.spans(ctx)
    dart = [s for s in spans if s[2].startswith("qr.dart.")]
    if not dart:
        return None
    # the program spans that start inside a qr.dart span (they nest, so they
    # end inside it too), found by walking both lists in start order
    children, i = [], 0
    for s in spans:
        while i < len(dart) and dart[i][1] < s[0]:
            i += 1
        if i < len(dart) and dart[i][0] <= s[0] and s is not dart[i] and s[1] <= dart[i][1]:
            children.append(s)
    return _spans.per_tree_ms(ctx, _spans.total_ns(dart) - _spans.overlap_ns(dart, children))
