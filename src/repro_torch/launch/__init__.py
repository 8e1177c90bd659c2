"""Launch layer of the port: the serving launcher (``launch.serve``) and
the training launcher (``launch.train``)."""
