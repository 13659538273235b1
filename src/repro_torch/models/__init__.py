"""Models of the port: the paper's prototype CNN and the MLP classifier
(``cnn``), and the transformer LM of the launch path (``layers``,
``attention``, ``mlp``, ``transformer``)."""
