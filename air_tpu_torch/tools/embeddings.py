"""Embedding-projector dataset tool, the port's copy of
``air_tpu/tools/embeddings.py``.

Parity with reference embeddings.py: run inference on the test set, match
ground-truth digits to inferred attention steps by spatial-transformer-space
center distance (greedy nearest <= max_distance, reference
embeddings.py:86-110), then write a TensorBoard-projector-compatible
dataset: latent vectors, a window sprite sheet, and label metadata
(reference embeddings.py:117-142,201-222).

Output format: plain projector files (vectors TSV + metadata TSV + sprite
PNG + projector_config.pbtxt) — loadable by the standalone embedding
projector and TensorBoard; no TF checkpoint required. The sprite sheet is
written by the port's own PNG writer (``train/visualize.py:write_png``), so
the tool needs no PIL.
"""

from __future__ import annotations

import math
import os

import numpy as np

from air_tpu_torch.train.visualize import write_png


def collect_data_info(digits, indices, positions, boxes, labels,
                      canvas_size: int = 50):
    """Ground-truth digit geometry incl. ST-space centers
    (reference embeddings.py:29-59: st_center = pixel_center/24.5 - 1)."""
    half = (canvas_size - 1.0) / 2.0
    all_info = []
    for i in range(len(digits)):
        info = {"num_digits": int(digits[i]), "digits": []}
        for j in range(int(digits[i])):
            x, y = positions[i][j * 2:(j + 1) * 2]
            w, h = boxes[i][j * 2:(j + 1) * 2]
            cx = (x + x + w - 1.0) / 2.0
            cy = (y + y + h - 1.0) / 2.0
            info["digits"].append({
                "id": int(indices[i][j]),
                "position": [int(x), int(y)],
                "box": [int(w), int(h)],
                "center": [cx, cy],
                "st_center": [cx / half - 1.0, cy / half - 1.0],
                "label": int(labels[i][j]),
            })
        all_info.append(info)
    return all_info


def collect_reconstruction_info(digits, positions, windows, latents,
                                window_size: int = 28):
    """Inferred attention geometry (reference embeddings.py:62-83)."""
    all_info = []
    for i in range(len(digits)):
        info = {"num_digits": int(digits[i]), "digits": []}
        for j in range(int(digits[i])):
            info["digits"].append({
                "scale": float(positions[i][j][0]),
                "shift": np.asarray(positions[i][j][1:]),
                "window": np.asarray(windows[i][j]).reshape(window_size,
                                                            window_size),
                "latent": np.asarray(latents[i][j]),
            })
        all_info.append(info)
    return all_info


def match_data_with_rec(data_info, reconstruction_info, max_distance=0.1):
    """Greedy nearest-center matching (reference embeddings.py:86-110)."""
    all_info = []
    for img in range(len(data_info)):
        taken = []
        for dig in range(data_info[img]["num_digits"]):
            closest, min_dist = -1, 3.0
            gt = data_info[img]["digits"][dig]["st_center"]
            for k in range(reconstruction_info[img]["num_digits"]):
                shift = reconstruction_info[img]["digits"][k]["shift"]
                d = math.hypot(shift[0] - gt[0], shift[1] - gt[1])
                if d < min_dist:
                    min_dist, closest = d, k
            if min_dist <= max_distance and closest not in taken:
                all_info.append({
                    "id": data_info[img]["digits"][dig]["id"],
                    "label": data_info[img]["digits"][dig]["label"],
                    "image": reconstruction_info[img]["digits"][closest]
                    ["window"],
                    "latent": reconstruction_info[img]["digits"][closest]
                    ["latent"],
                })
                taken.append(closest)
    return all_info


def create_sprites(images, window_size: int, path: str):
    """Square sprite sheet, an 8-bit grey PNG; digits drawn dark-on-light
    (reference embeddings.py:117-131)."""
    dim = int(math.ceil(math.sqrt(len(images))))
    sheet = np.ones((dim * window_size, dim * window_size), np.float32)
    for i, img in enumerate(images):
        x, y = i % dim, i // dim
        sheet[y * window_size:(y + 1) * window_size,
              x * window_size:(x + 1) * window_size] -= img
    return write_png(path, (np.clip(sheet, 0, 1) * 255).astype(np.uint8))


def create_metadata(labels, path: str):
    """Index/Label TSV (reference embeddings.py:134-142)."""
    with open(path, "w") as f:
        f.write("Index\tLabel\n")
        for i, lab in enumerate(labels):
            f.write(f"{i}\t{lab}\n")
    return path


def write_projector_dataset(results_folder: str, latents, images, labels,
                            window_size: int = 28, name: str = "air_mnist"):
    """Write the full projector dataset (vectors/metadata/sprites/config)."""
    os.makedirs(results_folder, exist_ok=True)
    vec_path = os.path.join(results_folder, f"{name}_tensors.tsv")
    np.savetxt(vec_path, np.asarray(latents), delimiter="\t", fmt="%.6g")
    meta_path = create_metadata(labels,
                                os.path.join(results_folder,
                                             "mnist_metadata.tsv"))
    sprite_path = create_sprites(images, window_size,
                                 os.path.join(results_folder,
                                              "mnist_sprites.png"))
    config_path = os.path.join(results_folder, "projector_config.pbtxt")
    with open(config_path, "w") as f:
        f.write(
            "embeddings {\n"
            f"  tensor_name: \"{name}\"\n"
            f"  tensor_path: \"{os.path.basename(vec_path)}\"\n"
            f"  metadata_path: \"{os.path.basename(meta_path)}\"\n"
            "  sprite {\n"
            f"    image_path: \"{os.path.basename(sprite_path)}\"\n"
            f"    single_image_dim: {window_size}\n"
            f"    single_image_dim: {window_size}\n"
            "  }\n"
            "}\n")
    return {"tensors": vec_path, "metadata": meta_path,
            "sprites": sprite_path, "config": config_path}


def run(wrapper, test_data_file: str, results_folder: str,
        canvas_size: int = 50, window_size: int = 28, max_distance: float = 0.2,
        verbose: bool = True):
    """End-to-end: infer -> match -> projector files
    (reference embeddings.py:149-222). Returns match statistics."""
    from air_tpu_torch.data.records import read_test_data

    images, digits, indices, positions, boxes, labels = \
        read_test_data(test_data_file)
    dat_info = collect_data_info(digits, indices, positions, boxes, labels,
                                 canvas_size)
    rec_digits, rec_positions, _, rec_windows, rec_latents, _ = \
        wrapper.infer(images)
    rec_info = collect_reconstruction_info(rec_digits, rec_positions,
                                           rec_windows, rec_latents,
                                           window_size)
    latent_info = match_data_with_rec(dat_info, rec_info, max_distance)

    label_dic = {d: 0 for d in range(10)}
    for info in latent_info:
        label_dic[info["label"]] += 1
    stats = {
        "present_digits": int(sum(i["num_digits"] for i in dat_info)),
        "inferred_digits": int(sum(i["num_digits"] for i in rec_info)),
        "matched": len(latent_info),
        "label_distribution": label_dic,
    }
    if verbose:
        print(f"Present digits: {stats['present_digits']}")
        print(f"Inferred digits: {stats['inferred_digits']}")
        print(f"Matched inference boxes: {stats['matched']}")
        print(f"Digit distribution (among matched digits): {label_dic}")

    if latent_info:
        write_projector_dataset(
            results_folder,
            np.array([i["latent"] for i in latent_info]),
            np.array([i["image"] for i in latent_info]),
            [i["label"] for i in latent_info],
            window_size)
    return stats
