"""Plain PyTorch version of the embedding-bag kernel (K4)."""
import torch


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      fields: int = 1) -> torch.Tensor:
    """table [fields·V, D], ids [N, H] → [N, D]: bag ``i`` sums the rows
    ``(i % fields)·V + ids[i, h]``.  The rows are added in ``h`` order in
    float32 and the sum is cast to the table's dtype once, the order and
    rounding of the kernel."""
    n, bag = ids.shape
    rows = table.shape[0] // fields
    offset = (torch.arange(n, device=ids.device) % fields) * rows
    gathered = table[ids.long() + offset[:, None]]           # [N, H, D]
    acc = torch.zeros((n, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for h in range(bag):
        acc = acc + gathered[:, h].float()
    return acc.to(table.dtype)
