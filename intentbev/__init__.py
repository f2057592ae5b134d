"""intentbev — BEV detection + intention prediction framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of
Nadeem202020/VisionTransformer-Intention-Prediction (IntentNet on Argoverse 2
with CNN and ViT backbones). See SURVEY.md for the blueprint.
"""

from . import configs

__version__ = "0.1.0"
