"""Median over the window's passes of the bytes of the CLI's PNG per image
row, as written: how hard the deflate works on the traffic's images."""


def read(ctx):
    return ctx.median("png_bytes_per_row")
