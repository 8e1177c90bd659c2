"""Launch layer of the port: the serving launcher (``launch.serve``), its
mesh factory (``launch.mesh``) and the training launcher
(``launch.train``)."""
