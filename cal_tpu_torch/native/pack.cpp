// Native batch packer of the port: the hot host-side loop of the data loader.
//
// A copy of cal_tpu/native/pack.cpp (pack_dense_batch and pack_sparse_batch,
// the same outputs bit for bit), with one addition: pack_sparse_batch also
// writes the batch's stable sender order (send_perm) when it is handed each
// graph's, so the sparse loader needs no per-batch argsort.  One C call packs
// a batch from whole-dataset concatenated arrays (PackedDataset in
// native/__init__.py), where the NumPy packers (graph.py pack_dense,
// data/loader.py _SparseDataset.pack) loop or gather in Python.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -o libcalpack.so pack.cpp, done at
// first use by cal_tpu_torch/native/__init__.py into build/cal_tpu_torch_native/.
#include <cstdint>
#include <cstring>

extern "C" {

// Pack a dense-layout batch.
//
// Inputs (concatenated over the WHOLE dataset, built once):
//   all_x      [total_nodes, feat]  node features
//   node_off   [n_graphs_total+1]   node offsets per graph
//   all_recv/all_send [total_edges] within-graph edge endpoints, sorted by
//                                   (recv, send) within each graph
//   edge_off   [n_graphs_total+1]   edge offsets per graph
//   all_y      [n_graphs_total]     labels
//   idx        [bs]                 dataset indices of this batch's graphs
//
// Outputs (pre-allocated by the caller, zero-fill NOT required):
//   x_out        [num_graphs, node_budget, feat]
//   edge_flat    [edge_budget]  sorted flat adjacency indices; padding
//                holds the sentinel num_graphs*node_budget^2
//   n_nodes_out  [num_graphs]   real node count per slot (0 for padding)
//   y_out        [num_graphs]
//
// Returns 0 on success, -1 if a graph exceeds the node budget, -2 if the
// batch exceeds the edge budget.
int pack_dense_batch(
    const float* all_x, const int64_t* node_off,
    const int32_t* all_recv, const int32_t* all_send,
    const int64_t* edge_off, const int32_t* all_y,
    const int32_t* idx, int bs,
    int feat, int node_budget, int edge_budget, int num_graphs,
    float* x_out, int64_t* edge_flat, int32_t* n_nodes_out, int32_t* y_out) {
  const int64_t nb = node_budget;
  const int64_t sentinel = (int64_t)num_graphs * nb * nb;
  std::memset(x_out, 0, sizeof(float) * (size_t)num_graphs * nb * feat);
  int64_t e_off = 0;
  for (int i = 0; i < bs; ++i) {
    const int32_t g = idx[i];
    const int64_t n0 = node_off[g], n1 = node_off[g + 1];
    const int64_t e0 = edge_off[g], e1 = edge_off[g + 1];
    const int64_t n = n1 - n0, e = e1 - e0;
    if (n > node_budget) return -1;
    if (e_off + e > edge_budget) return -2;
    std::memcpy(x_out + (size_t)i * nb * feat, all_x + (size_t)n0 * feat,
                sizeof(float) * (size_t)n * feat);
    const int64_t base = (int64_t)i * nb * nb;
    for (int64_t k = 0; k < e; ++k) {
      edge_flat[e_off + k] =
          base + (int64_t)all_recv[e0 + k] * nb + all_send[e0 + k];
    }
    e_off += e;
    n_nodes_out[i] = (int32_t)n;
    y_out[i] = all_y[g];
  }
  for (int i = bs; i < num_graphs; ++i) {
    n_nodes_out[i] = 0;
    y_out[i] = 0;
  }
  for (int64_t k = e_off; k < edge_budget; ++k) edge_flat[k] = sentinel;
  // No sort: each graph's edges are presorted by (recv, send) and the
  // per-slot bases increase, so the concatenation of sorted runs is globally
  // sorted already.
  return 0;
}

// Pack a sparse-layout (disjoint-union) batch: concatenated nodes/edges
// with node-index offsets, receiver-sorted edges.  senders/receivers padding
// points at node num_nodes-1.  With all_send_order (each graph's edges in
// stable sender order, as global edge ids) and send_perm_out both non-null,
// also writes send_perm_out [num_edges]: the batch's stable sender order
// (padded edges last, in their own order).
int pack_sparse_batch(
    const float* all_x, const int64_t* node_off,
    const int32_t* all_recv, const int32_t* all_send,
    const int64_t* edge_off, const int32_t* all_y,
    const int32_t* idx, int bs,
    int feat, int num_nodes, int num_edges, int num_graphs,
    float* x_out, int32_t* senders_out, int32_t* receivers_out,
    uint8_t* edge_mask_out, uint8_t* node_mask_out, int32_t* node_graph_out,
    int32_t* y_out, uint8_t* graph_mask_out,
    const int64_t* all_send_order, int64_t* send_perm_out) {
  std::memset(x_out, 0, sizeof(float) * (size_t)num_nodes * feat);
  const bool perm = all_send_order != nullptr && send_perm_out != nullptr;
  int64_t n_cur = 0, e_cur = 0;
  for (int i = 0; i < num_graphs; ++i) {
    y_out[i] = 0;
    graph_mask_out[i] = 0;
  }
  for (int i = 0; i < bs; ++i) {
    const int32_t g = idx[i];
    const int64_t n0 = node_off[g], n = node_off[g + 1] - n0;
    const int64_t e0 = edge_off[g], e = edge_off[g + 1] - e0;
    if (n_cur + n > num_nodes || e_cur + e > num_edges) return -1;
    std::memcpy(x_out + (size_t)n_cur * feat, all_x + (size_t)n0 * feat,
                sizeof(float) * (size_t)n * feat);
    for (int64_t k = 0; k < e; ++k) {
      senders_out[e_cur + k] = all_send[e0 + k] + (int32_t)n_cur;
      receivers_out[e_cur + k] = all_recv[e0 + k] + (int32_t)n_cur;
      edge_mask_out[e_cur + k] = 1;
    }
    if (perm)
      for (int64_t k = 0; k < e; ++k)
        send_perm_out[e_cur + k] = all_send_order[e0 + k] - e0 + e_cur;
    for (int64_t k = 0; k < n; ++k) {
      node_mask_out[n_cur + k] = 1;
      node_graph_out[n_cur + k] = i;
    }
    y_out[i] = all_y[g];
    graph_mask_out[i] = 1;
    n_cur += n;
    e_cur += e;
  }
  for (int64_t k = n_cur; k < num_nodes; ++k) {
    node_mask_out[k] = 0;
    node_graph_out[k] = num_graphs;  // trash segment
  }
  for (int64_t k = e_cur; k < num_edges; ++k) {
    senders_out[k] = num_nodes - 1;
    receivers_out[k] = num_nodes - 1;
    edge_mask_out[k] = 0;
    if (perm) send_perm_out[k] = k;
  }
  // Receiver-sorted by construction: each graph's edges are presorted by
  // (recv, send) and node offsets increase per slot, so concatenated offset
  // receivers are globally non-decreasing.  Padded edges point at node
  // num_nodes-1 (the maximum id), preserving sortedness; their senders are
  // the largest id too, so they stay last in the sender order.
  return 0;
}

}  // extern "C"
