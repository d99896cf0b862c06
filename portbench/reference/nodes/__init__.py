"""One file a scene node: ``distance(p, prm, kids, static)`` of points
``p`` (N, 3), the node's parameters ``prm`` (name -> tensor), its children's
distance functions ``kids`` and its static settings.  ``reference/scene.py``
finds a node's file by the ``op`` name of the configuration's scene tree."""
