"""One reader a metric (``<name>.py``, ``read(ctx)``), and the counts and peaks they share."""
