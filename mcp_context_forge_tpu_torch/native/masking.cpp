// Hot-path sensitive-value masking for request/response logging.
//
// The port's own copy of the JAX package's native/masking.cpp (the C++
// counterpart of the upstream gateway's Rust request-logging masking
// extension: sensitive-key masking with a key-sensitivity cache). Exposed
// through a plain C ABI consumed via ctypes; utils/masking.py builds it with
// g++ into build/native/ at first use.
//
// Strategy: single pass over the JSON text. Track the most recent string that
// syntactically sits in key position ("key" followed by ':'); when the key is
// sensitive, replace the following scalar/string value with "***". A small
// open-addressing cache memoizes key→sensitive decisions (keys repeat heavily
// across log records).

#include <atomic>
#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

const char* kSensitiveSubstrings[] = {
    "password", "passwd", "secret", "token", "api_key", "apikey",
    "authorization", "auth", "credential", "private_key", "session_id",
    "cookie", "x-api-key", "client_secret", "access_key", "bearer",
};

// Each entry packs (hash & ~1) | sensitive-bit into one atomic word so that
// concurrent readers/writers (ctypes releases the GIL) can never observe a
// torn hash/verdict pair. 0 doubles as the empty sentinel.
constexpr size_t kCacheSize = 512;  // power of two
std::atomic<uint64_t> g_cache[kCacheSize];

uint64_t fnv1a(const char* data, size_t len) {
  uint64_t hash = 1469598103934665603ull;
  for (size_t i = 0; i < len; ++i) {
    hash ^= static_cast<unsigned char>(data[i]);
    hash *= 1099511628211ull;
  }
  return hash;
}

bool key_is_sensitive_uncached(const std::string& lower) {
  for (const char* needle : kSensitiveSubstrings) {
    if (lower.find(needle) != std::string::npos) return true;
  }
  return false;
}

bool key_is_sensitive(const char* key, size_t len) {
  std::string lower(len, '\0');
  for (size_t i = 0; i < len; ++i)
    lower[i] = static_cast<char>(std::tolower(static_cast<unsigned char>(key[i])));
  // bit 63 marks "occupied" (so 0 stays the empty sentinel) without
  // biasing the low bits used for slot selection
  uint64_t hash = fnv1a(lower.data(), lower.size()) | (1ull << 63);
  std::atomic<uint64_t>& slot = g_cache[(hash >> 1) & (kCacheSize - 1)];
  uint64_t packed = slot.load(std::memory_order_relaxed);
  if ((packed & ~1ull) == (hash & ~1ull) && packed != 0)
    return packed & 1ull;
  bool sensitive = key_is_sensitive_uncached(lower);
  slot.store((hash & ~1ull) | (sensitive ? 1ull : 0ull),
             std::memory_order_relaxed);
  return sensitive;
}

// Scan a JSON string literal starting at the opening quote; returns the index
// one past the closing quote (or end).
size_t scan_string(const char* text, size_t i, size_t n) {
  ++i;  // opening quote
  while (i < n) {
    if (text[i] == '\\') {
      i += 2;
      continue;
    }
    if (text[i] == '"') return i + 1;
    ++i;
  }
  return n;
}

}  // namespace

extern "C" {

// Returns a malloc'd NUL-terminated masked copy; caller frees with mask_free.
char* mask_sensitive(const char* input, size_t len) {
  std::string out;
  out.reserve(len + 16);
  size_t i = 0;
  while (i < len) {
    char c = input[i];
    if (c != '"') {
      out.push_back(c);
      ++i;
      continue;
    }
    size_t end = scan_string(input, i, len);
    size_t key_start = i + 1;
    size_t key_len = (end >= 2 && end > key_start) ? end - 1 - key_start : 0;
    // lookahead: is this string a key (next non-space char is ':')?
    size_t j = end;
    while (j < len && std::isspace(static_cast<unsigned char>(input[j]))) ++j;
    bool is_key = j < len && input[j] == ':';
    out.append(input + i, end - i);
    i = end;
    if (!is_key || key_len == 0) continue;
    if (!key_is_sensitive(input + key_start, key_len)) continue;
    // copy up to and including ':', then mask the value
    while (i < len && input[i] != ':') out.push_back(input[i++]);
    if (i < len) out.push_back(input[i++]);  // ':'
    while (i < len && std::isspace(static_cast<unsigned char>(input[i])))
      out.push_back(input[i++]);
    if (i >= len) break;
    if (input[i] == '"') {
      size_t value_end = scan_string(input, i, len);
      out.append("\"***\"");
      i = value_end;
    } else if (input[i] == '{' || input[i] == '[') {
      // structured value: mask wholesale (balanced scan)
      char open = input[i], close = (open == '{') ? '}' : ']';
      int depth = 0;
      size_t k = i;
      while (k < len) {
        if (input[k] == '"') {
          k = scan_string(input, k, len);
          continue;
        }
        if (input[k] == open) ++depth;
        if (input[k] == close && --depth == 0) {
          ++k;
          break;
        }
        ++k;
      }
      out.append("\"***\"");
      i = k;
    } else {
      // number / literal
      while (i < len && input[i] != ',' && input[i] != '}' && input[i] != ']' &&
             !std::isspace(static_cast<unsigned char>(input[i])))
        ++i;
      out.append("\"***\"");
    }
  }
  char* result = static_cast<char*>(std::malloc(out.size() + 1));
  if (result == nullptr) return nullptr;  // caller treats as "mask in Python"
  std::memcpy(result, out.data(), out.size());
  result[out.size()] = '\0';
  return result;
}

void mask_free(char* ptr) { std::free(ptr); }

}  // extern "C"
