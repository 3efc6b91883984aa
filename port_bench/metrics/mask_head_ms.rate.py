"""``mask_head_ms.rate``: device kernel milliseconds launched inside
``bench.mask_head`` (the forward of the model's ``mask_head``: its pooling
through kernel 2 at P=14, its convolutions and the class gather), per call,
one call a bucket; None where the slice holds no such range (a program
without a mask head)."""


def read(ctx):
    tl = getattr(ctx, "timeline", None)
    rs = [] if tl is None else tl.ranges_named(r"bench\.mask_head$")
    return sum(tl.kernel_ms(r) for r in rs) / len(rs) if rs else None
