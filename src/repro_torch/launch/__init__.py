"""Launch layer of the port: the serving launcher (``launch.serve``)."""
