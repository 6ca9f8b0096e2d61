"""Unbatched inference with composite multi-class targets, the port's own
copy of ``sl_hwgat_tpu/train/inference.py`` (reference
`hwgat/inference.py:10-124`): a target is digit-encoded (its first digit is
the number of sub-classes, then 4-digit class ids), and a sample counts as
correct when every sub-class is among the top predictions.
"""

from __future__ import annotations

import numpy as np
import torch


def decode_classes(target: int) -> tuple[int, list[int]]:
    """≡ `inference.py:74-81`."""
    s = str(target)
    num_cls = int(s[0])
    s = s[1:]
    return num_cls, [int(s[i * 4 : i * 4 + 4]) for i in range(num_cls)]


def evaluate_composite(model: torch.nn.Module, dataset, top: int = 5) -> float:
    """Unbatched composite-target accuracy of ``model`` in eval mode, on the
    device of its parameters. ≡ `inference.py:83-112`.

    ``dataset.get(i)`` returns (feat (T, V, C), composite target int).
    Samples with target 0 are left out of the denominator.
    """
    device = next(model.parameters()).device
    model.eval()
    correct, length = 0, len(dataset)
    for i in range(len(dataset)):
        feat, target = dataset.get(i)
        if int(target) == 0:
            length -= 1
            continue
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(feat, np.float32))[None].to(device)
            logits = model(x)[0].float().cpu().numpy()
        prediction = np.argsort(logits)[::-1][:top].tolist()
        num_cls, all_cls = decode_classes(int(target))
        if sum(c in prediction for c in all_cls) == num_cls:
            correct += 1
    return correct / max(length, 1)


def show_final_result_composite(model: torch.nn.Module, loaders: dict, top: int = 5):
    """≡ `inference.py:114-124`."""
    accs = {split: evaluate_composite(model, ds, top) for split, ds in loaders.items()}
    print("=" * 89)
    print(
        f"train acc {accs.get('train', 0):5.4f} | val acc {accs.get('val', 0):5.4f} "
        f"| test acc {accs.get('test', 0):5.4f}"
    )
    print("=" * 89)
    return accs
