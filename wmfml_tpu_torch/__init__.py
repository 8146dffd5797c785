"""PyTorch + CUDA port of ``wmfml_tpu`` for NVIDIA Hopper (H100).

A package of its own beside the JAX one: it imports ``torch`` and numpy,
never ``jax`` and nothing of ``wmfml_tpu``. Entry points run on ``cuda``
unless the caller passes ``device=cpu``; the hand-written kernels live in
``csrc/`` and are bound in ``kernels/``.

Ported so far: ShapeNet1D and Pascal1D meta-training of the four
literature-encoder methods (CNPShapeNet1D, ANPShapeNet1D,
CNPVanillaPascal1D, ANPVanillaPascal1D) and second-order MAML
(MAMLShapeNet1D, VanillaMAML), in float32 or bf16; Distractor's and
ShapeNet3D's LargeCNP methods (CNPDistractor, ANPDistractor,
CondNeuralProcess, ANP) in float32 or bf16; the MR and FCL methods; the
SingleTask baselines; image augmentation in random or fixed order and task
augmentation for all four tasks; the statistical evaluation, single-task
refinement, single-task evaluation and evaluate-and-plot CLIs. ROADMAP.md
lists what is still to port.
"""

__version__ = "0.1.0"
