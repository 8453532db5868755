from .y4m import Y4MReader, Y4MWriter, read_clip, write_clip  # noqa: F401
