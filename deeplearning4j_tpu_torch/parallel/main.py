"""Data-parallel training CLI (port of deeplearning4j_tpu/parallel/main.py).

Parity with the reference's ParallelWrapperMain (reference:
deeplearning4j-scaleout-parallelwrapper/.../parallelism/main/
ParallelWrapperMain.java + DataSetIteratorProviderFactory.java: load a
saved model, obtain an iterator from a named factory class, train
data-parallel, save). The factory is any ``module:callable`` returning
a DataSetIterator.

    python -m deeplearning4j_tpu_torch.parallel.main \\
        --model-path model.zip \\
        --iterator-provider mypkg.data:make_train_iterator \\
        --workers 1 --epochs 2 --model-output trained.zip

Run as it stands it trains on one rank (the plain network, on CUDA
unless ``--device cpu``). Run on every rank of a process group
(`parallel.multihost.initialize_multihost`), it trains data-parallel
over ``--workers`` ranks (default: all of them); rank 0 saves.
"""
from __future__ import annotations

import argparse
import importlib
from typing import Any, Callable


def load_provider(spec: str) -> Callable[[], Any]:
    """Resolve 'module.path:attr' to the iterator factory callable."""
    if ":" not in spec:
        raise ValueError(
            f"iterator provider '{spec}' must be 'module:callable' "
            "(the DataSetIteratorProviderFactory analog)")
    mod_name, attr = spec.split(":", 1)
    mod = importlib.import_module(mod_name)
    factory = getattr(mod, attr)
    if not callable(factory):
        raise TypeError(f"{spec} is not callable")
    return factory


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Data-parallel training of a saved model "
                    "(ParallelWrapperMain analog)")
    ap.add_argument("--model-path", required=True,
                    help="saved model zip (ModelSerializer format)")
    ap.add_argument("--iterator-provider", required=True,
                    help="module:callable returning a DataSetIterator")
    ap.add_argument("--workers", type=int, default=None,
                    help="data-parallel ranks (default: every rank)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--model-output", default=None,
                    help="where to save the trained model "
                         "(default: overwrite --model-path)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
    from deeplearning4j_tpu_torch.util.model_guesser import ModelGuesser
    from deeplearning4j_tpu_torch.util.model_serializer import write_model

    net = ModelGuesser.load_model_guess(args.model_path, device=args.device)
    factory = load_provider(args.iterator_provider)
    pw = ParallelWrapper(net, workers=args.workers)
    for epoch in range(args.epochs):
        # fresh iterator per epoch: one-shot providers (generators)
        # would otherwise silently train only epoch 0
        pw.fit(factory())
        print(f"epoch {epoch}: score {float(net.score_value):.6f}")
    out = args.model_output or args.model_path
    if not dist.is_initialized() or dist.get_rank() == 0:
        write_model(net, out)
        print(f"saved trained model to {out}")


if __name__ == "__main__":
    main()
