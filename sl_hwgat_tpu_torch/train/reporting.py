"""Reporting: loss/acc curve PNGs, the final top-k table and the per-class
confusion CSV. The port's own copy of ``sl_hwgat_tpu/train/reporting.py``
(reference `hwgat/utils.py:144-161, 292-350`).
"""

from __future__ import annotations

import csv

import numpy as np


def plot_results(train_list, val_list, option, y_label, save_path, size=(640, 480)):
    """Overwrite a curve PNG each epoch: a grid, the two curves (matplotlib's
    first two colours), the legend, the labels and the title, drawn with
    Pillow. ≡ `utils.py:292-307`, which draws the same figure with
    matplotlib."""
    from PIL import Image, ImageDraw

    w, h = size
    left, right, top, bottom = 70, 20, 40, 50
    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    values = [float(v) for v in (*train_list, *val_list)]
    lo, hi = (min(values), max(values)) if values else (0.0, 1.0)
    if hi - lo < 1e-12:
        lo, hi = lo - 0.5, hi + 0.5
    n = max(len(train_list), len(val_list), 1)

    def xy(i, v):
        x = left + (w - left - right) * (i / (n - 1) if n > 1 else 0.5)
        y = top + (h - top - bottom) * (1.0 - (float(v) - lo) / (hi - lo))
        return x, y

    for t in range(6):  # grid and tick labels
        gx = left + (w - left - right) * t / 5
        gy = top + (h - top - bottom) * t / 5
        draw.line([(gx, top), (gx, h - bottom)], fill=(220, 220, 220))
        draw.line([(left, gy), (w - right, gy)], fill=(220, 220, 220))
        draw.text((4, gy - 6), f"{hi - (hi - lo) * t / 5:.4g}", fill="black")
        draw.text((gx - 6, h - bottom + 6), f"{(n - 1) * t / 5:.3g}", fill="black")
    draw.rectangle([left, top, w - right, h - bottom], outline="black")
    for k, (series, colour) in enumerate(((train_list, (31, 119, 180)),
                                          (val_list, (255, 127, 14)))):
        points = [xy(i, v) for i, v in enumerate(series)]
        if len(points) > 1:
            draw.line(points, fill=colour, width=2)
        for x, y in points:
            draw.ellipse([x - 2, y - 2, x + 2, y + 2], fill=colour)
        label = f"{'train' if k == 0 else 'validation'} {option}"
        draw.line([(w - right - 150, top + 12 + 16 * k), (w - right - 125, top + 12 + 16 * k)],
                  fill=colour, width=2)
        draw.text((w - right - 120, top + 6 + 16 * k), label, fill="black")
    draw.text((w / 2 - 30, 12), f"{option} curve", fill="black")
    draw.text((w / 2 - 20, h - 22), "epochs", fill="black")
    draw.text((4, top - 24), y_label, fill="black")
    img.save(save_path, format="PNG")


def show_final_result(results: dict, k: int = 1):
    """Print the final train/val/test table. ≡ `utils.py:309-322`."""
    print("=" * 89)
    print(
        f"train acc {results['train'][1]:5.4f} | val acc {results['val'][1]:5.4f} "
        f"| test acc {results['test'][1]:5.4f}"
    )
    print(
        f"train loss {results['train'][0]:2.4f} | val loss {results['val'][0]:2.4f} "
        f"| test loss {results['test'][0]:2.4f}"
    )
    print("=" * 89)


def read_class_map(path: str) -> dict[int, str]:
    class_map = {}
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            class_map[int(row[0])] = row[1]
    return class_map


def gen_cm_w(y_true, y_pred, class_map: dict[int, str], save_path: str):
    """Per-class confusion CSV with the breakdown of predictions.
    ≡ `utils.py:324-350`."""
    n = len(class_map)
    cm = np.zeros((n, n))
    for tr, pr in zip(y_true, y_pred):
        cm[tr, pr] += 1
    with open(save_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["word", "total", "predicted"])
        for i, row in enumerate(cm):
            total = row.sum()
            predicted = "".join(
                f"word-{class_map[j]}({row[j]}) " for j in range(n) if row[j] > 0
            )
            writer.writerow([f"Word-{class_map[i]}", str(total), predicted])
